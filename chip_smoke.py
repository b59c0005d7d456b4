#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only program_train --repeat 6
    python3 chip_smoke.py --only fleet
    python3 chip_smoke.py --only bert,vision
    python3 chip_smoke.py --only nmt

Needs one CUDA card and ``nvcc``; imports nothing of JAX or
``paddle_tpu``. ``--only`` runs the named phases alone after the build
(``engine_features``, ``program_train``, ``inference_server``,
``gateway``, ``fleet``, ``programs``, ``bert``, ``vision``, ``nmt``),
``--repeat``
times, printing each run's line whether it passed or not. Phases, one
JSON line each:

1. env     torch / CUDA / nvcc versions, the card, TF32 turned off.
2. build   compiles every kernel from ``paddle_tpu_torch/csrc`` (sm_90a)
           and reports each instantiation's ``ptxas`` registers and
           spill stores.
3. kernels each kernel against its plain PyTorch version on the card at
           the shapes its path gives it (serving: prefill and decode;
           training: the forward with dropout 0.1 and both backward
           kernels at [8, 12, 1024, 64], causal, padded key bias): max
           abs error against the stated tolerance, kernel / plain /
           library (SDPA) device times (a CUDA graph of 20 calls
           replayed over five windows of >= 100 ms each: the median, the
           kernel's window spread beside it), and the bound (the least
           time the card could take for the same work).
           The paged kernel has no single-call library counterpart: a
           gather of the rows plus SDPA (two calls) is timed beside it.
           The backward kernels' library call is SDPA's backward alone
           (``backward(g, retain_graph=True)`` on a saved SDPA output with
           the same mask and its own dropout), which returns dq, dk and
           dv from the same residuals; SDPA forward + backward is kept
           beside it. The fp32 training kernels (split TF32 on the tensor
           cores: the forward, dq and dk/dv) print their bound at three
           TF32 products at 495 TFLOP/s beside the 67 TFLOP/s fp32 bound
           of the table.
4. engine  GPT-2 small at full width (random weights from a seed)
           served by ``DecodeEngine(slots=8, max_len=1024)``: 8 greedy
           requests, some joining mid-flight; checks that both kernels'
           launch counts moved on that run, and holds every step's logits
           teacher-forced against the plain full forward on the card.
5. engine_features  the same model through the contiguous engine with
           the prefix store and windows (``prefix_cache_mb=96``: 21
           blocks of 64 tokens; ``prefill_chunk=256``), four runs: 8
           requests sharing a 512-token system prompt (the first misses
           and publishes its 8 blocks, the other 7 hit all 512 tokens);
           a 990-token prompt admitted as 4 windows while 4 streams
           decode, each of them emitting between every two windows; a
           run-1 stream resumed after 16 tokens, continuing with the
           run's own tokens; 8 batch streams of 64 tokens of which 2 are
           preempted for 2 interactive requests and still end whole.
           Every token teacher-forced as above; ``flash_fwd`` launched
           12 times for every whole-prompt prefill, ``flash_decode`` for
           every step; TTFT on a miss and on a hit, the resume windows'
           ms by bucket, the live streams' inter-token p99 during the
           long admission, tokens/s, peak memory.
6. paged   the same model through the paged engine with speculation
           (``block_size=16, spec_tokens=4``, prefix index on, max_len
           1016): three runs of 8 requests — width 4 with the n-gram
           drafter, width 4 with a drafter replaying run 1 (prefix hits,
           accepted drafts), width 1 (the paged kernel every step);
           checks launches, lengths, no shed, hits and acceptance, and
           every emitted token teacher-forced.
7. profile torch.profiler over a decode step (8 active slots), a
           990-token prefill, and the paged step at width 1 and 4 (8
           slots at position 500): wall vs device-busy time, top ops;
           each decode step's decode-kernel device ms and launches a
           step, which must be one a layer (the split-K merge adds no
           launch).
8. train   GPT-2 small's eager train step (``build_gpt_lm_train_eager``)
           at batch 8 x 1024: at dropout 0, every parameter's step-1
           gradient through the kernels against the dense path
           (``use_flash_attention=False``) as a relative norm; at
           dropout 0.1, 20 Adam steps on a learnable token stream whose
           loss must stay finite and fall, with each of the three flash
           kernels launched 12 times a step; step ms, tokens/s, peak
           memory, and one profiled step (device busy and idle share,
           top device ops).
9. program_train  the same train step as a Fluid Program
           (``build_gpt_lm_train``) run by ``fluid.Executor(CUDAPlace(0))``
           from the same weights (``load_fluid_scope``): at dropout 0, 10
           Adam steps whose losses must equal the eager step's within
           1e-4 relative, step p50, a profiled step of each (idle share,
           launches by class: GEMM, flash, copy, other; the program must
           run as many GEMM ops as the eager step, counted on the host,
           neither trace more GEMM kernels than its ops, and each flash
           kernel 12 times), peak memory; then 20 program steps at
           dropout 0.1 on the learnable stream: the loss falls and each
           flash kernel launches 12 x 20 times.
10. bias    a program with a learnable per-head attention bias
           (``fluid.layers.create_parameter([1, 12, 1024, 1024])`` fed to
           ``fluid.layers.flash_attention(q, k, v, bias=...)``, q/k/v from
           fc over a [8, 1024, 768] input, causal) trained 5 Adam steps;
           the step-1 dq/dk/dv/dbias the kernels gave held against the
           plain versions on the same tensors.
11. amp_train  the AMP (bf16) train step, ``build_gpt_lm_train(cfg,
           1024, use_amp=True)`` through ``fluid.Executor(CUDAPlace(0))``
           at 8 x 1024 from phase 9's weights and feed: 10 steps at
           dropout 0 whose step-1 loss (1e-4 relative) and step-1
           gradients of the first and last layers' weights and the LM
           head (1e-1 relative norm) must match the fp32 program's, with
           each bf16 flash kernel launched 12 times a step and no generic
           replay; step p50, a profiled step (idle share, launches by
           class, the GEMM and flash kernels by name), peak memory; the
           eager AMP step beside it (step-1 loss within 1e-6 of the
           program's, bf16 flash kernels); then 20 program steps at
           dropout 0.1 that must learn.
12. inference_server  GPT-2 small saved by ``save_inference_model``,
           loaded by ``AnalysisPredictor`` (held against the eager
           forward) and served by ``InferenceServer`` from 8 closed-loop
           clients against the same requests run alone; generation
           through a ``DecodeEngine`` over the predictor's parameters.
13. gateway  the same model over HTTP (``serving.Gateway``) with the
           strict build gate armed and the exporter on port 0: 4 SSE
           generations beside 4 classifier clients, then 2 GPT-2
           /v1/infer requests; every streamed token teacher-forced and
           compared with the in-process generation, the GPT-2 logits bit
           for bit the in-process ones, the classifier's bit for bit one
           of its batch buckets', launches, 0 builds after warmup, 429
           and 504, /metrics, a client's traceparent on its spans and
           /trace, the access logs; a paged speculative engine behind
           the same front (width 4, then width 1); a SIGTERM drain in a
           child process (``python -m paddle_tpu_torch.tools.gateway_probe
           --gpt2 --drain-only``). Records the HTTP hop against in
           process (TTFT, infer p50/p99, tokens/s), the drain seconds and
           the card's idle share over the storm.
14. fleet  the serving control plane. First the port's closed-loop probe
           with its replicas on the card (``python -m
           paddle_tpu_torch.tools.fleet_probe --fast --device cuda``:
           failover, autoscale, rollout, strict gate, durable
           generations, the KV tier, controller durability). Then GPT-2
           small from a ``FleetController`` of 3 replicas (1 prefill
           role, 2 decode; ``--gpt-decode`` with GPT-2's widths, seed 0,
           paged, host tier on) spawned through this script's hidden
           ``--fleet-replica`` mode, all traffic through its ``Router``:
           8 SSE streams behind one 512-token prefix (the first pulls the
           chain from the prefill peer over ``/v1/kv/prefill``, the rest
           hit it by affinity), two more 512-token prefixes that spill
           the first to the host tier, the first again (readmitted from
           the host), 6 streams of which one replica's die mid-stream
           (chaos) and resume on the survivor, and a ``deploy()`` of a
           second GPT-2 version under ``/v1/infer`` traffic. Every token
           teacher-forced, resumed streams against an uninterrupted run,
           every ``/v1/infer`` answer bit for bit its version's oracle,
           pull/spill/readmit counters, 0 builds after warmup, and each
           replica's own launches (written when it drains) against its
           steps and forwards. Records the router hop, the pull against
           a local prefill, the tier's D2H/H2D copies, the failover blip,
           replica cold starts, peak memory per replica and the card's
           idle share (``nvidia-smi`` utilization).

15. programs  (run after the profile phase) the KV-cache serving
           programs: GPT-2 small through the reference's program-form
           ``DecodeSession(cfg, place=CUDAPlace(0), scope)`` (the
           ``build_gpt_*`` programs run by ``fluid.Executor``) beside the
           eager session over the same parameter tensors, every call on
           the same inputs, teacher-forced. Contiguous (8 slots, max_len
           1024, the default ladder, resume windows, a 4-block prefix
           store): 8 prefills, a publish and a copy-in (a prefix hit on
           slot 7), a resume window, 32 steps. Paged (block 16, the
           default pool, width 4): windows of at most 512 tokens, 32
           width-1 steps, a width-4 verify, a block copy. Logits within
           1e-4, every cache row, store and pool block (the sink aside)
           within 1e-5; ``flash_fwd`` 12 a prefill, ``flash_decode`` 12 a
           step, ``flash_decode_paged`` 12 a width-1 step, none in the
           dense windows and verify. The step's host p50, device busy
           and idle share, program against eager. Then the reference's
           ``greedy_generate(exe, infer, logits, cfg, prompt, ...)``: 64
           tokens held to the plain forward and the eager form.
16. bert   (run after amp_train) BERT-base's sequence classifier,
           ``build_bert_classifier(cfg, 384)`` at batch 24 through
           ``fluid.Executor(CUDAPlace(0))``, ragged key-padding masks
           (real lengths 160-384): at dropout 0 the flash program's
           step-1 loss and every gradient against the dense program's
           from the same weights (1e-3 relative norm; 12 launches of each
           training kernel, no generic replay); 20 Adam steps at dropout
           0.1 on one batch that must learn, launch counts zeroed just
           before them and read just after (12 a step each); one AMP
           step against the fp32 step (only bf16 flash kernels, 12 each);
           fp32 and AMP step ms, seq/s, idle share, peak memory; dense
           and flash step ms at seq 128 (batch 64) and 384 (batch 24).
17. vision LeNet (SGD, 20 steps on 64 images that must learn) and
           ResNet-50 (224x224, 1000 classes, Momentum): step 1 at batch 4
           on the card against the same program on the CPU in fp32 and in
           fp64 (loss, three gradients, every batch norm's running
           stats), 10 timed steps at batch 32 (images/s, idle share,
           launches, peak memory), one AMP step with bf16 convolutions.
18. nmt    (run after vision) Transformer NMT at Transformer-base's
           widths (``models/transformer.py``) through
           ``fluid.Executor(CUDAPlace(0))``: ``build_transformer_train``
           at batch 64, source 64, target 48, ragged masks, label
           smoothing 0.1, dropout 0. Flash against the dense program from
           the same weights at step 1 (loss, every gradient; 18 launches
           of each training kernel: 6 encoder, 6 decoder-self, 6 cross);
           the copy task's 30 Noam-scheduled Adam steps that must learn,
           launch counts zeroed just before and read just after, the
           ``@LR_DECAY_COUNTER@`` read every step; ``beam_search_decode``
           over ``build_transformer_infer`` on the trained weights (4
           sources of 32, beam 4), every step's logits and choices held
           to the dense program, 18 ``flash_fwd`` a step, its time split
           into the run and the logits' copy to the host; a ``While`` RNN
           and a ``cond`` with their gradients on the card against the
           CPU, with the host syncs a loop iteration. Step ms, target
           tokens/s, idle share, peak memory.

The kernels phase also checks and times the general-bias
instantiations at the train shape with dropout 0.1, for the per-head
[1, 12, 1024, 1024] and the [1024, 1024] bias; the bf16 forms of the
three training kernels at the train shape (timed, with their bf16 bound
and SDPA in bf16 beside them; all three on the tensor cores); the three
training kernels at the BERT classifier's shape ([24, 12, 384, 64],
non-causal, ragged key bias, dropout 0.1) in fp32 and bf16, each timed
beside its plain version, its bound and SDPA with the key-padding mask;
the three at the NMT's cross form (q [64, 8, 48, 64] against k/v
[64, 8, 64, 64], non-causal, ragged key bias, dropout 0) the same way;
the bf16
forms of both decode kernels at their serving shapes
(timed beside SDPA in bf16, held to ``lowp_limits.out_bound``); fp16 and
bf16 at small shapes; a head dim of 48 on all five kernels; and both
decode kernels at head dims 200, 256, 20 and 3 in fp32 and bf16, each
against its plain version. The decode kernels' rows carry their split
count and cluster size (``_decode_splits``), the copy ring's stages,
their bound share, every instantiation's registers and spills from the
build phase, and a run-to-run check (two calls on the same inputs must
give equal bits); a fully masked slot is held to the kernel limits too,
its largest error reported on its own.
The amp_train phase reports the flash kernels' device ms a step, by
kernel.

Then the kernel table as one JSON line, the card's name and power limit
as ``nvidia-smi`` reports them, and last ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; without a CUDA device it exits 1
before printing anything.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel vs plain version, both fp32 on the card: the kernels sum QK^T
# and PV in another order (online softmax over key tiles and thread
# groups vs one dense softmax; the training forward in split TF32, whose
# products keep ~2^-22 of fp32), which moves outputs of magnitude ~1 by a
# few ulps per term; 2e-5 absolute leaves ~100 ulps of room, while a
# masking or indexing error shows as O(0.1).
KERNEL_ATOL, KERNEL_RTOL = 2e-5, 1e-4
# The backward kernels against their plain versions: dq, dk and dv sum
# up to 1024 products per entry and dkey_bias sums ds over every query
# row, so ~1e-6 of honest difference; one wrong mask entry or tile bound
# moves them by O(0.01-1).
BWD_ATOL, BWD_RTOL = 1e-4, 1e-4
# Engine logits vs the plain full forward, teacher-forced: 12 fp32
# layers whose products run as different cuBLAS shapes (one row vs the
# whole sequence) and whose attention runs kernel vs dense. Observed
# differences are ~5e-6 on logits of std ~0.5 (NVIDIA H100 80GB HBM3,
# 700.00 W); a wrong cache position or mask moves them by O(0.1).
LOGIT_ATOL = 1e-3

PROMPT_LENS = (5, 31, 64, 130, 257, 500, 700, 990)
NEW_TOKENS = 32
# The train step: GPT-2's sequence length at a batch of 8 sequences
# (GPT-2 trained with 512). Step-1 gradients through the kernels vs the
# dense path, per parameter ||g_flash - g_dense|| / ||g_dense||: fp32 both
# ways, 12 layers of products summed in other orders give ~1e-6 to 1e-5;
# a masking or dropout error in a kernel gives O(1). The denominator is
# floored at 1e-6 of the whole gradient's norm: the k-projection biases
# have an exact gradient of zero (softmax ignores a shift shared by all
# keys of a query), so both paths return rounding noise for them.
TRAIN_BATCH, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 8, 1024, 20, 3e-4
GRAD_REL_TOL, GRAD_NORM_FLOOR = 1e-3, 1e-6
# The program step vs the eager step at dropout 0, per step: the same
# fp32 functions summed in other orders (ops vs modules: separate bias
# adds, the loss over a sliced view) move a loss of ~10 by ~1e-6.
PROGRAM_STEPS, PROGRAM_LOSS_RTOL = 10, 1e-4
# dbias of a per-head bias shared by the 8 sequences of the batch: the
# kernel adds each head's ds with float atomics in no fixed order, so it
# differs from the plain version's ordered sum by rounding of 8-term
# sums (~1e-7 relative); held at the backward tolerance.
BIAS_STEPS = 5
# The bf16 and fp16 kernels against their plain versions on the same
# low-precision inputs are held to the limits of
# ``paddle_tpu_torch/tools/lowp_limits.py``: out per element to the bound
# of its p rounding and per 64-row block to 1 eps of relative norm; dq,
# dk and dv per element to 2 ulps of their row's largest entry and per
# block to 0.1 eps; lse, dkey_bias and dbias (fp32 sums) to 1e-4.
# The AMP train step (bf16 products and attention, fp32 layer norms, loss
# and master weights) against the fp32 program step on the same weights
# and feed, at dropout 0. With random weights the step-1 loss sits near
# ln(vocab) whatever attention does, so it is held loosely (read: 3.3e-6
# relative, NVIDIA H100 80GB HBM3, 700 W) and the step-1 gradients of the
# attention and FFN weights of the first and last layers and of the LM
# head carry the check: bf16 products move them by ~1e-2 of their norm
# (1.0e-2 to 1.8e-2 on a 12-layer GPT of width 128 on the CPU), a masking
# or indexing error in a bf16 kernel by O(1). The eager AMP
# step runs the same functions in the same order as the program: its
# step-1 loss read equal to the program's to the last bit.
AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_EAGER_RTOL = 1e-4, 1e-1, 1e-6
AMP_GRAD_PARAMS = ("gpt_0_att_q.w_0", "gpt_0_att_k.w_0", "gpt_0_att_v.w_0",
                   "gpt_0_att_out.w_0", "gpt_0_ffn_fc0.w_0",
                   "gpt_11_att_q.w_0", "gpt_11_att_k.w_0", "gpt_11_att_v.w_0",
                   "gpt_11_att_out.w_0", "gpt_11_ffn_fc1.w_0", "lm_head.w_0")
# BERT-base's sequence classifier (BASELINE.json's second headline model)
# through fluid.Executor(CUDAPlace(0)): vocab 30522, hidden 768, 12 layers
# of 12 heads, FFN 3072, 512 positions, at seq 384 and batch 24 (the
# reference bench's batch above seq 128, bench_bert.py:161-165). Its
# attention runs the training kernels in their non-causal form under a
# ragged key-padding bias: each row's real length is drawn from 160-384,
# its sentence ids switch to 1 halfway through it, its label is random.
# Flash against the dense path (the same weights, dropout 0): the step-1
# loss and every parameter's gradient within 1e-3 relative norm, the
# denominator floored as in the GPT train phase (the k-projection biases'
# exact gradient is 0 here too). Learning: 20 Adam steps at lr 1e-4 on the
# one fixed batch at dropout 0.1 (the labels are random: the model
# memorizes 24 of them); the mean of the last 5 losses must sit 0.1 below
# the first 5's (from ln 2 = 0.69). AMP (bf16 products and attention):
# the step-1 loss within 1e-2 relative of the fp32 step's, and the
# gradients of layer 0's and layer 11's Q projections and of cls within
# 1e-1 relative norm; layer 11's V projection and FFN input weights are
# held with them. Layer 11's Q projection is recorded, not held (nor are
# the other layers' Q): at random init the deep layers' keys collapse
# toward their mean, so the true dq (which sees only the keys' spread) is
# small, and the flash backward's delta = rowsum(dO∘O), taken from the
# bf16 O as in the reference (``flash_attention.py:748``), leaves each
# row's ds a sum of order eps·|dO·O| that multiplies the keys' mean:
# the phase records each layer's reading for the flash AMP program
# (1.1% at layer 0 growing to 103% at layer 11, NVIDIA H100 80GB HBM3,
# 700.00 W) and for the dense AMP program beside it, whose softmax
# backward takes the mean from the same dp. The dense/flash crossover:
# step ms of both at seq 128 (batch 64) and seq 384 (batch 24), dropout
# 0.1.
BERT_SEQ, BERT_BATCH, BERT_MIN_LEN = 384, 24, 160
BERT_STEPS, BERT_LR, BERT_LEARN_MARGIN = 20, 1e-4, 0.1
BERT_LOSS_RTOL = 1e-3
BERT_AMP_LOSS_RTOL, BERT_AMP_GRAD_RTOL = 1e-2, 1e-1
BERT_AMP_GRAD_PARAMS = ("layer_0_att_q.w_0", "layer_11_att_v.w_0",
                        "layer_11_ffn_fc0.w_0", "cls.w_0")
BERT_Q_PARAMS = tuple("layer_%d_att_q.w_0" % i for i in range(12))
BERT_CROSSOVER = ((128, 64), (384, 24))
BERT_TIMED_STEPS = 6
# Transformer NMT (Transformer-base's widths: 6 + 6 layers, hidden 512, 8
# heads, FFN 2048, vocabularies of 30000) through fluid.Executor on the
# card, dropout 0, label smoothing 0.1, batch 64 of source 64 and target
# 48 tokens with ragged real lengths (``nmt_lengths``). Flash against
# dense from the same weights: the step-1 loss within 1e-4 relative and
# every parameter's gradient within GRAD_REL_TOL relative norm, floored
# as in the train phases, but the k-projection biases: their exact
# gradient is 0, so each side's must be below 1e-5 of the whole
# gradient's norm;
# 18 launches of each training kernel a step (6 encoder, 6 decoder-self,
# 6 cross). Learning: the reference's copy task (``tests/
# test_transformer_nmt.py``'s data form: target = BOS + source, labels =
# source, at this width) for 30 Adam steps under learning_rate 0.1 x the
# Noam schedule with 16 warmup steps (peak 1.1e-3); the mean of the last
# 5 losses must sit 0.1 below the first 5's. Beam search
# (``beam_search_decode``, 4 sources of 32, beam 4, target 32) on the
# trained weights: every step's logits at the real target positions
# within LOGIT_ATOL of the dense program's on the same feed (padded
# query rows attend differently in the two forms), every chosen
# extension among the dense totals' top 4 or within 1e-3 of the 4th, the
# final scores recomputed through the dense program within 1e-3 x T, 18
# flash_fwd launches a step. Control flow: the ``While`` RNN of
# ``tests/test_while_cond_grad.py`` at B 64, T 32, H 512 and a ``cond``
# on its result, with ``append_backward``, on the card against the same
# program on the CPU: loss within 1e-5 relative, dloss/dW within 1e-4
# relative norm.
NMT_BATCH, NMT_SRC, NMT_TGT, NMT_MIN_SHARE = 64, 64, 48, 3
NMT_STEPS, NMT_LR, NMT_WARMUP, NMT_LEARN_MARGIN = 30, 0.1, 16, 0.1
NMT_LOSS_RTOL, NMT_ZERO_GRAD_SHARE = 1e-4, 1e-5
NMT_BEAM_N, NMT_BEAM_K, NMT_BEAM_LEN = 4, 4, 32
NMT_BOS, NMT_EOS = 1, 0
NMT_RNN_B, NMT_RNN_T, NMT_RNN_H = 64, 32, 512
NMT_RNN_LOSS_RTOL, NMT_RNN_GRAD_RTOL = 1e-5, 1e-4
# The vision programs through fluid.Executor(CUDAPlace(0)), TF32 off
# (cuDNN's too). LeNet: 64 random 1x28x28 images, 10 classes, SGD at 0.01
# for 20 steps on the fixed batch; the mean of the last 5 losses must sit
# below the first 5's. ResNet-50: 224x224, 1000 classes, Momentum at lr
# 0.1, mu 0.9. Step 1 at batch 4 on the card against the same program,
# weights and batch on fluid.CPUPlace() (fp32), and in fp64 on the CPU
# (the scope's tensors and the image in fp64: every op computes in its
# inputs' type). The loss within 1e-4 relative of the CPU's, the fc
# weight's gradient within 1e-3 relative norm, every batch norm's MeanOut
# and VarianceOut within 1e-4. The stem conv's filter and a mid-network
# batch-norm scale: their fp32 gradients are only ~2% accurate on any
# device (the backward through 50 batch norms at random init cancels:
# card and CPU read 2.2-2.4% from the fp64 run and 2.5-2.6% from each
# other, NVIDIA H100 80GB HBM3, 700.00 W), so each checked gradient's
# distance from the fp64 run must be at most 1.5x the CPU fp32 run's; a
# wrong layout, padding or statistic moves it by O(1). Then 10 steps at
# batch 32, timed, and one AMP step.
LENET_BATCH, LENET_STEPS, LENET_LR = 64, 20, 0.01
RESNET_BATCH, RESNET_CHECK_BATCH, RESNET_STEPS = 32, 4, 10
RESNET_LOSS_RTOL, RESNET_GRAD_RTOL, RESNET_STAT_RTOL = 1e-4, 1e-3, 1e-4
RESNET_F64_RATIO = 1.5
RESNET_GRAD_PARAMS = ("conv2d_0.w_0", "batch_norm_26.w_0", "fc_0.w_0")
# The paged engine: max_len 1016 leaves room for the width-4 verify's
# positions (max_len + k - 1 <= 1024), so tables are 64 blocks of 16 (a
# key span of 1024) and the pool 8 * 64 + 1 blocks; the longest prompt
# is cut from 990 to 960 to fit. 192 MiB lets the prefix index pin 170
# blocks of 1.125 MiB, more than the 165 full blocks the prompts have.
PAGED_PROMPT_LENS = (5, 31, 64, 130, 257, 500, 700, 960)
PAGED_MAX_LEN, PAGED_BLOCK, SPEC_K, PAGED_PREFIX_MB = 1016, 16, 4, 192.0
# The engine's features on the contiguous pool: a 96 MiB prefix store
# holds 21 blocks of 64 tokens (12 layers x K and V x 12 heads x 64 x 64
# x 4 bytes = 4.5 MiB a block), windows of at most 256 tokens. Run 1:
# eight requests share a 512-token system prompt (8 blocks) before
# distinct suffixes; the first suffix is shorter than a block, so the
# first request publishes exactly the 8 system blocks. Run 2: a
# 990-token prompt admits as 4 windows (256/256/256/222) while 4 streams
# decode. Run 3: a run-1 stream resumed after its first 16 tokens. Run
# 4: 8 batch streams of 64 tokens fill the slots, then 2 interactive
# requests preempt two of them.
FEATURE_PREFIX_MB, FEATURE_CHUNK, FEATURE_BLOCKS = 96.0, 256, 21
SYSTEM_LEN, SUFFIX_LENS = 512, (8, 200, 13, 77, 150, 31, 64, 120)
CHUNKED_LEN, LIVE_LENS, LIVE_NEW = 990, (20, 45, 9, 60), 64
RESUME_AFTER = 16
BATCH_LENS, BATCH_NEW, INTERACTIVE_LENS = (12, 30, 7, 55, 21, 40, 16,
                                           33), 64, (25, 11)

# The KV-cache serving programs: GPT-2 small through the reference's
# program-form DecodeSession (the build_gpt_* programs run by
# fluid.Executor(CUDAPlace(0))) beside the eager DecodeSession over the
# same parameter tensors, call by call on the same inputs, teacher-forced.
# Both are fp32 with TF32 off and run the same kernels; the products run
# as other op sequences (fc as mul + add, the LM head over the whole
# window before the selection), so logits of std ~0.5 differ by ~1e-5 at
# most and the K/V rows and blocks they write by ~1e-6; a wrong slot,
# offset, block or mask moves them by O(0.1). Contiguous: 8 prefills, a
# publish and a copy-in of one 64-token block (a prefix hit on slot 7),
# a resume window, 32 steps. Paged: windows of at most 512 tokens, 32
# width-1 steps, one width-4 verify, one block copy. Then the reference's
# greedy_generate(exe, infer, logits, cfg, ...): 64 new tokens.
PROG_LOGIT_ATOL, PROG_STATE_ATOL = 1e-4, 1e-5
PROG_STEPS, PROG_WINDOW = 32, 512
PROG_PREFIX_BLOCKS, PROG_PREFIX_BLOCK = 4, 64
PROG_GEN_PROMPT, PROG_GEN_NEW = 20, 64
PROG_TIMED_STEPS = 20

# The inference path: GPT-2 small saved by save_inference_model, served
# by AnalysisPredictor and InferenceServer. The predictor (flash_fwd,
# program ops, fc as mul + add) is held against the eager GPTLM with the
# plain attention (use_flash=False), at every shape the served batches
# give flash_fwd: 1 and 8 rows, seq 64/128/256, the last of 8 rows
# padded by the key bias. Kernel against plain and program against
# eager differ by ~1e-5 on logits of std ~0.5 (fp32, TF32 off); a wrong
# weight, layout, mask or kernel tile moves them by O(0.1). Served
# results against the same request run alone: the batch's rows and pad
# change the products' shapes only (held at the same 1e-3).
INFER_CHECKS = ((1, 64), (1, 128), (1, 256), (8, 64), (8, 128), (8, 256))
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_LENS = 8, 12, (20, 256)
SERVE_SEQ_BUCKETS = (64, 128, 256)
GEN_LENS, GEN_NEW = (20, 77, 150, 256), 32
# The HTTP gateway over the same inference path, under the armed strict
# gate with the exporter listening: a storm of 4 SSE generations (20-500
# prompt tokens, 32 new each) beside 4 clients posting the probe's small
# classifier to /v1/infer (6 requests each), then 2 GPT-2 /v1/infer
# requests of 64 tokens one at a time ([1, 64, 50257] logits, ~3.2 M
# floats of JSON each). The classifier's rows are held bit for bit to
# the in-process result at the batch bucket they rode; GPT-2's to the
# in-process server.infer of the same row (batch 1 both ways). The paged
# trial: 2 streams at width 4 (the done events carry the drafts), then 2
# at width 1 (the paged kernel every step). The SIGTERM drain runs in a
# child process (the probe's --gpt2 --drain-only).
GW_GEN_LENS, GW_GEN_NEW = (20, 100, 260, 500), 32
GW_CLASSIFIER_CLIENTS, GW_CLASSIFIER_REQS = 4, 6
GW_INFER_SEQ, GW_INFER_RUNS = 64, 2
GW_PAGED_LENS = (40, 300)
# The serving fleet: the port's closed-loop probe on the card first
# (``paddle_tpu_torch.tools.fleet_probe --fast --device cuda``), then
# GPT-2 small from a FleetController of 3 paged replicas (1 prefill role,
# 2 decode) behind its Router. Each replica serves the saved GPT-2 on
# /v1/infer ([1, 64] rows, batch 1) and a seeded GPT-2 decode engine on
# /v1/generate (block 16, slots 8, max_len 1024). Its prefix index holds
# 48 blocks of 1.125 MiB (54 MB): one 512-token chain (32 blocks) and one
# prompt's suffix (a 700-token prompt has 43 blocks; a prompt whose chain
# outgrew the index would evict its own root, which the LRU holds
# oldest), so two more 512-token chains push the first one out to the
# host tier; its host tier 256 MB; a decode replica pulls a chain from the prefill
# peer when it would cache fewer than 256 of a prompt's tokens; the
# replicas advertise up to 64 chain heads (the index's whole content),
# so a prompt's shared prefix stays among the advertised keys. Replica 2
# SIGKILLs itself after its 24th SSE token (chaos).
FLEET_SPEC = {"seed": 0, "vocab_size": 50257, "hidden_size": 768,
              "num_layers": 12, "num_heads": 12, "intermediate_size": 3072,
              "use_flash_attention": True, "max_len": 1024, "slots": 8}
FLEET_INFER_SEQ = 64
FLEET_PREFIX, FLEET_NEW = 512, 32
FLEET_SHARED_LENS = (520, 540, 560, 590, 620, 650, 680, 700)
FLEET_FAILOVER_LENS = (40, 90, 150, 200, 250, 300)
FLEET_DIE_REPLICA, FLEET_DIE_AFTER = 2, 24
FLEET_READMIT_MIN = 496   # 31 of a 512-token prefix's 32 blocks
FLEET_ENV = {
    "FLAGS_decode_block_size": "16",
    "FLAGS_decode_prefix_cache_mb": "54",
    "FLAGS_kv_tier_host_mb": "256",
    "FLAGS_kv_tier_pull_min_tokens": "256",
    "FLAGS_kv_tier_advert_k": "64",
    "FLAGS_serving_strict_compiles": "1",
    "FLAGS_serving_max_batch_size": "1",
    "FLAGS_obs_snapshot_interval_s": "1.0",
    "FLAGS_chaos_die_after_tokens": str(FLEET_DIE_AFTER),
    "FLAGS_chaos_die_replica": str(FLEET_DIE_REPLICA),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def ptxas_report(log):
    """{kernel instantiation: "R registers, S bytes spill stores"} from
    nvcc's ``-Xptxas=-v`` report, the instantiation named from its
    mangled name as ``kernel<type, D, dropout, bias>``."""
    out, name = {}, None
    spill = "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"(flash_\w+?_kernel)I(\w*?)EEv", m.group(1))
            if k:
                ty = re.match(r"(?:\d+(\w+?)|(f))L", k.group(2))
                ty = ty and (ty.group(1) or "float")
                args = ([ty] if ty else []) + re.findall(r"L[ib](\d+)",
                                                         k.group(2))
                kernel = k.group(1)[k.group(1).rfind("flash_"):]
                name = "%s<%s>" % (kernel, ", ".join(args))
            else:
                name = m.group(1)[:80]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = "%s registers, %s bytes spill stores" % (
                m.group(1), spill)
            name, spill = None, "?"
    return out


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def card_peaks(name):
    """(bytes/s, fp32 FLOP/s) from NVIDIA's H100 data sheet for the part
    the device name says (dense, non-tensor-core fp32)."""
    if "PCIe" in name:
        return 2.0e12, 51.2e12, "H100 PCIe: 2.0 TB/s, 51.2 TFLOP/s fp32"
    if "NVL" in name:
        return 3.9e12, 60.0e12, "H100 NVL: 3.9 TB/s, 60 TFLOP/s fp32"
    return 3.35e12, 67.0e12, "H100 SXM: 3.35 TB/s, 67 TFLOP/s fp32"


def cuda_ms(fn, inputs, calls=20, window_ms=100.0, windows=5):
    """Per-call device ms of ``fn``. ``calls`` calls, cycling through
    ``inputs`` (argument tuples, so repeated calls can read cold data),
    are captured once in a CUDA graph; the graph is replayed to fill
    windows of at least ``window_ms`` each, timed with CUDA events, after
    one untimed window. Replaying keeps the host's per-call cost (the
    Python wrapper, the ctypes call) out of the reading: the card runs
    the calls back to back, so a host slower than the kernel cannot
    stretch it. Returns (median over ``windows`` windows, [min, max])."""
    for i in range(3):                 # build, allocator, library plans
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(*inputs[i % len(inputs)])

    def window(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * calls)

    reps = max(1, int(np.ceil(window_ms / (window(1) * calls))))
    window(reps)                       # untimed: clocks up
    times = sorted(window(reps) for _ in range(windows))
    return times[len(times) // 2], [times[0], times[-1]]


def bound_ms(nbytes, flops, peaks, flops_rate=None):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over ``flops_rate`` (default: the card's fp32 rate)."""
    bw, fp32, _src = peaks
    rate = fp32 if flops_rate is None else flops_rate
    t_bytes, t_ops = nbytes / bw * 1e3, flops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# dense bf16/fp16 and TF32 tensor-core peaks of the H100 SXM (NVIDIA's
# data sheet)
BF16_PEAK = 989e12
TF32_PEAK = 495e12
# the training kernels: how each computes, by element type
BF16_DESIGN = {"flash_fwd": "mma.sync m16n8k16 (tensor cores)",
               "flash_bwd_dq": "mma.sync m16n8k16 (tensor cores)",
               "flash_bwd_dkv": "mma.sync m16n8k16 (tensor cores)"}
FP32_DESIGN = dict.fromkeys(
    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
    "split TF32: 3 x mma.sync m16n8k8 (tensor cores)")


def tf32_bound_ms(flops):
    """The split-TF32 fp32 kernels' bound on the tensor cores: each fp32
    product taken as three TF32 products at the TF32 peak."""
    return 3 * flops / TF32_PEAK * 1e3


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    # in fp32: a bf16 or fp16 difference would itself be rounded
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError("%s disagrees with its plain version: max abs "
                             "err %.3g" % (name, max_err(got, want)))


def check_decode_close(name, got, want, key_bias):
    """An fp32 decode kernel's out [B, N, 1, D] against its plain
    version's at the kernel limits, fully masked slots (``key_bias``
    [B, S] all -1e4) included. Returns the largest error on the slots
    with a live key and on the fully masked ones."""
    check_close(name, got, want)
    masked = (key_bias < -1e3).all(1)
    return (max_err(got[~masked], want[~masked]),
            max_err(got[masked], want[masked]) if masked.any() else 0.0)


def decode_lowp_ratio(name, got, want, q, k, v, key_bias, scale):
    """A bf16 or fp16 decode kernel's out against its plain version's,
    per element within ``lowp_limits.out_bound`` at rate 0 (the kernel
    rounds the running p, the plain version the normalised one); ``k``
    and ``v`` are the cache rows it reads. Returns the largest ratio
    (1 or less passes) and raises above 1."""
    from paddle_tpu_torch.tools import lowp_limits as lowp

    if got.dtype != q.dtype:
        raise AssertionError("%s returned %s" % (name, got.dtype))
    bound = lowp.out_bound(q.dtype, q, k, v, want, key_bias=key_bias,
                           scale=scale)
    return lowp.check(name, {
        "elem": lowp.out_ratios(q.dtype, got, want, bound)["elem"]})


def decode_design(kernel):
    """The split-K decode kernels' constants as their library reports
    them: threads a block, key rows a thread group takes a tile, stages of
    the copy ring, the largest cluster. The threads and rows must be the
    wrapper module's ``_DECODE_DESIGN``, which the CPU tests emulate."""
    import ctypes

    from paddle_tpu_torch.kernels import _build, flash_attention as fa

    out = (ctypes.c_int * 4)()
    _build.load(kernel, "f32").library.paddle_flash_decode_design(out)
    design = dict(zip(("threads", "rows_per_group", "stages", "max_cluster"),
                      list(out)))
    if (out[0], out[1]) != fa._DECODE_DESIGN[kernel]:
        raise AssertionError("%s: built as %s, emulated as %s" % (
            kernel, design, fa._DECODE_DESIGN[kernel]))
    return design


def check_repeatable(name, fn, first):
    """A second call of ``fn`` must give ``first``'s bits: the decode
    kernels merge their splits' states in a fixed order."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("%s: two calls on the same inputs differ (max "
                             "%.3g)" % (name, max_err(first, again)))
    return True


def event_ms(fn, reps=10):
    """Per-call device ms of ``fn`` run eagerly ``reps`` times between two
    CUDA events, after three warmup calls: for work that a CUDA graph
    cannot hold (a backward through autograd) and that is long enough
    (milliseconds) for the host's per-call cost to hide behind it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_flash_fwd(dev, peaks):
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(0)
    B, N, D = 1, 12, 64
    scale = 1.0 / np.sqrt(D)
    rows, worst = [], 0.0
    for T, live in ((128, 100), (1024, 990)):
        q, k, v = (torch.randn(B, N, T, D, generator=gen).to(dev)
                   for _ in range(3))
        kb = torch.zeros(B, T)
        kb[:, live:] = -1e4          # ragged key-padding tail
        kb = kb.to(dev)
        out, lse = fa.flash_attention_lse(q, k, v, kb, causal=True,
                                          scale=scale)
        ref_out, ref_lse = fa.flash_attention_lse_plain(
            q, k, v, key_bias=kb, causal=True, scale=scale)
        torch.cuda.synchronize()
        check_close("flash_fwd out T=%d" % T, out, ref_out)
        check_close("flash_fwd lse T=%d" % T, lse, ref_lse)
        err = max(max_err(out, ref_out), max_err(lse, ref_lse))
        worst = max(worst, err)
        causal_mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
        sdpa_mask = causal_mask[None, None] + kb.reshape(B, 1, 1, T)
        args = [(q, k, v, kb)]
        ms, spread = cuda_ms(lambda a, b, c, d: fa.flash_attention_lse(
            a, b, c, d, causal=True, scale=scale), args)
        plain_ms, _ = cuda_ms(
            lambda a, b, c, d: fa.flash_attention_lse_plain(
                a, b, c, key_bias=d, causal=True, scale=scale), args)
        lib_ms, _ = cuda_ms(
            lambda a, b, c, d: torch.nn.functional.scaled_dot_product_attention(
                a, b, c, attn_mask=sdpa_mask, scale=scale), args)
        pairs = B * N * T * (T + 1) // 2          # causal (q, k) pairs
        # q, k, v, o [B, N, T, D]; key bias [B, T]; lse [B, N, T]
        nbytes = 4 * (4 * B * N * T * D + B * T + B * N * T)
        bms, by = bound_ms(nbytes, 4 * D * pairs, peaks)
        rows.append({"T": T, "max_abs_err": err, "ms": ms,
                     "ms_window_spread": spread, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                     "bound_tensor_core_ms": tf32_bound_ms(4 * D * pairs),
                     "design": FP32_DESIGN["flash_fwd"]})
    fa.flash_attention_lse.launches = 0  # comparison launches do not count
    return worst, rows


def kernel_flash_decode(dev, peaks):
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(1)
    B, N, S, D = 8, 12, 1024, 64
    scale = 1.0 / np.sqrt(D)
    copies = 4  # 4 x 50 MB of K/V: each timed call reads cold data
    q = torch.randn(B, N, 1, D, generator=gen).to(dev)
    kvs = [(torch.randn(B, N, S, D, generator=gen).to(dev),
            torch.randn(B, N, S, D, generator=gen).to(dev))
           for _ in range(copies)]
    kb = torch.zeros(B, S)
    for b, live in enumerate((1, 17, 512, 1024, 100, 333, 1000)):
        kb[b, live:] = -1e4
    kb[7, :] = -1e4                  # a fully masked (inactive) slot
    kb = kb.to(dev)
    worst = masked_err = 0.0
    for k, v in kvs:
        out = fa.flash_decode_attention(q, k, v, kb, scale=scale)
        ref = fa.flash_decode_attention_plain(q, k, v, key_bias=kb,
                                              scale=scale)
        torch.cuda.synchronize()
        live, masked = check_decode_close("flash_decode", out, ref, kb)
        worst, masked_err = max(worst, live), max(masked_err, masked)
        check_repeatable("flash_decode", lambda: fa.flash_decode_attention(
            q, k, v, kb, scale=scale), out)
    args = [(q, k, v, kb) for k, v in kvs]
    ms, spread = cuda_ms(lambda a, b, c, d: fa.flash_decode_attention(
        a, b, c, d, scale=scale), args)
    plain_ms, _ = cuda_ms(lambda a, b, c, d: fa.flash_decode_attention_plain(
        a, b, c, key_bias=d, scale=scale), args)
    sdpa_mask = kb.reshape(B, 1, 1, S)
    lib_ms, _ = cuda_ms(
        lambda a, b, c, d: torch.nn.functional.scaled_dot_product_attention(
            a, b, c, attn_mask=sdpa_mask, scale=scale), args)
    BN = B * N
    # q, o [B, N, D]; k, v [B, N, S, D]; key bias [B, S]
    nbytes = 4 * (2 * BN * D + 2 * BN * S * D + B * S)
    bms, by = bound_ms(nbytes, 4 * D * BN * S, peaks)
    # the bf16 form on the same inputs rounded to bf16: within out_bound
    dt = torch.bfloat16
    args16 = [(q.to(dt), k.to(dt), v.to(dt), kb) for k, v in kvs]
    ratio = err16 = 0.0
    for a, b, c, d in args16:
        out = fa.flash_decode_attention(a, b, c, d, scale=scale)
        ref = fa.flash_decode_attention_plain(a, b, c, key_bias=d,
                                              scale=scale)
        torch.cuda.synchronize()
        ratio = max(ratio, decode_lowp_ratio("flash_decode[bf16]", out, ref,
                                             a, b, c, d, scale))
        err16 = max(err16, max_err(out, ref))
        check_repeatable("flash_decode[bf16]",
                         lambda: fa.flash_decode_attention(
                             a, b, c, d, scale=scale), out)
    ms16, spread16 = cuda_ms(lambda a, b, c, d: fa.flash_decode_attention(
        a, b, c, d, scale=scale), args16)
    plain16, _ = cuda_ms(lambda a, b, c, d: fa.flash_decode_attention_plain(
        a, b, c, key_bias=d, scale=scale), args16)
    mask16 = sdpa_mask.to(dt)
    lib16, _ = cuda_ms(
        lambda a, b, c, d: torch.nn.functional.scaled_dot_product_attention(
            a, b, c, attn_mask=mask16, scale=scale), args16)
    bms16, by16 = bound_ms(2 * (2 * BN * D + 2 * BN * S * D) + 4 * B * S,
                           4 * D * BN * S, peaks, BF16_PEAK)
    fa.flash_decode_attention.launches = 0
    splits = fa._decode_splits(BN, S, sms=fa._sm_count(dev.index or 0))
    return worst, {"max_abs_err": worst, "ms": ms, "ms_window_spread": spread,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
                   "masked_slot_max_abs_err": masked_err,
                   "library_ratio": ms / lib_ms, "repeatable": True,
                   "splits": splits, "cluster": splits,
                   "design": decode_design("flash_decode"),
                   "bf16": {"max_abs_err": err16, "out_bound_ratio": ratio,
                            "ms": ms16,
                            "ms_window_spread": spread16,
                            "plain_ms": plain16, "library_ms": lib16,
                            "bound_ms": bms16, "bound_by": by16,
                            "bound_share": bms16 / ms16,
                            "library_ratio": ms16 / lib16,
                            "repeatable": True}}


def kernel_flash_decode_paged(dev, peaks):
    """The paged decode kernel at the paged engine's shape: 8 slots, 12
    heads, tables of 64 blocks of 16 positions into a 513-block pool.
    Tables are a random permutation of the pool; slots 0 and 1 share
    their first 8 blocks (a prefix hit); slot 7 is all sink and fully
    masked (an inactive slot); live lengths are mixed."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(2)
    B, N, D, blk, MB = 8, 12, 64, 16, 64
    S, NB = MB * blk, B * MB + 1
    scale = 1.0 / np.sqrt(D)
    copies = 4  # 4 x 50 MB of pools: each timed call reads cold data
    q = torch.randn(B, N, 1, D, generator=gen).to(dev)
    pools = [(torch.randn(NB, N, blk, D, generator=gen).to(dev),
              torch.randn(NB, N, blk, D, generator=gen).to(dev))
             for _ in range(copies)]
    tables = (torch.randperm(NB - 1, generator=gen) + 1).reshape(B, MB)
    tables[1, :8] = tables[0, :8]
    tables[7] = 0
    kb = torch.zeros(B, S)
    for b, live in enumerate((1, 17, 512, 1024, 100, 333, 1000)):
        kb[b, live:] = -1e4
    kb[7, :] = -1e4
    mapped = int(torch.unique(tables).numel())
    tables = tables.to(torch.int32).to(dev)
    kb = kb.to(dev)
    worst = masked_err = 0.0
    for k_pool, v_pool in pools:
        out = fa.flash_decode_paged_attention(q, k_pool, v_pool, tables, kb,
                                              scale=scale)
        ref = fa.flash_decode_paged_attention_plain(q, k_pool, v_pool, tables,
                                                    key_bias=kb, scale=scale)
        torch.cuda.synchronize()
        live, masked = check_decode_close("flash_decode_paged", out, ref, kb)
        worst, masked_err = max(worst, live), max(masked_err, masked)
        check_repeatable("flash_decode_paged",
                         lambda: fa.flash_decode_paged_attention(
                             q, k_pool, v_pool, tables, kb, scale=scale), out)
    args = [(q, k, v, tables, kb) for k, v in pools]
    ms, spread = cuda_ms(lambda a, b, c, t, d: fa.flash_decode_paged_attention(
        a, b, c, t, d, scale=scale), args)
    plain_ms, _ = cuda_ms(
        lambda a, b, c, t, d: fa.flash_decode_paged_attention_plain(
            a, b, c, t, key_bias=d, scale=scale), args)
    sdpa_mask = kb.reshape(B, 1, 1, S)
    # no single PyTorch call reads K/V through a block table: the
    # yardstick is two, a gather of the logical rows (index_select)
    # then scaled_dot_product_attention over them
    lib_ms, _ = cuda_ms(
        lambda a, b, c, t, d: torch.nn.functional.scaled_dot_product_attention(
            a, fa.gather_paged_rows(b, t), fa.gather_paged_rows(c, t),
            attn_mask=sdpa_mask, scale=scale), args)
    BN = B * N
    # q, o [B, N, D]; K and V of every mapped block once; tables [B, MB]
    # int32; key bias [B, S]
    nbytes = 4 * (2 * BN * D + 2 * mapped * N * blk * D + B * MB + B * S)
    bms, by = bound_ms(nbytes, 4 * D * BN * S, peaks)
    dt = torch.bfloat16
    args16 = [(q.to(dt), k.to(dt), v.to(dt), tables, kb) for k, v in pools]
    ratio = err16 = 0.0
    for a, b, c, t, d in args16:
        out = fa.flash_decode_paged_attention(a, b, c, t, d, scale=scale)
        ref = fa.flash_decode_paged_attention_plain(a, b, c, t, key_bias=d,
                                                    scale=scale)
        torch.cuda.synchronize()
        rows = [fa.gather_paged_rows(x, t) for x in (b, c)]
        ratio = max(ratio, decode_lowp_ratio("flash_decode_paged[bf16]", out,
                                             ref, a, rows[0], rows[1], d,
                                             scale))
        err16 = max(err16, max_err(out, ref))
        check_repeatable("flash_decode_paged[bf16]",
                         lambda: fa.flash_decode_paged_attention(
                             a, b, c, t, d, scale=scale), out)
    ms16, spread16 = cuda_ms(
        lambda a, b, c, t, d: fa.flash_decode_paged_attention(
            a, b, c, t, d, scale=scale), args16)
    plain16, _ = cuda_ms(
        lambda a, b, c, t, d: fa.flash_decode_paged_attention_plain(
            a, b, c, t, key_bias=d, scale=scale), args16)
    mask16 = sdpa_mask.to(dt)
    lib16, _ = cuda_ms(
        lambda a, b, c, t, d: torch.nn.functional.scaled_dot_product_attention(
            a, fa.gather_paged_rows(b, t), fa.gather_paged_rows(c, t),
            attn_mask=mask16, scale=scale), args16)
    bms16, by16 = bound_ms(2 * (2 * BN * D + 2 * mapped * N * blk * D)
                           + 4 * (B * MB + B * S), 4 * D * BN * S, peaks,
                           BF16_PEAK)
    fa.flash_decode_paged_attention.launches = 0
    splits = fa._decode_splits(BN, S, blk, fa._sm_count(dev.index or 0))
    return worst, {"max_abs_err": worst, "ms": ms, "ms_window_spread": spread,
                   "plain_ms": plain_ms, "library_ms": None,
                   "gather_sdpa_ms": lib_ms,
                   "gather_sdpa_calls": "two: index_select gather of the K "
                                        "and V rows, then "
                                        "scaled_dot_product_attention",
                   "bound_ms": bms, "bound_by": by, "bound_share": bms / ms,
                   "masked_slot_max_abs_err": masked_err,
                   "repeatable": True, "mapped_blocks": mapped,
                   "splits": splits, "cluster": splits,
                   "design": decode_design("flash_decode_paged"),
                   "shape": {"q": [B, N, 1, D], "pool": [NB, N, blk, D],
                             "tables": [B, MB]},
                   "bf16": {"max_abs_err": err16, "out_bound_ratio": ratio,
                            "ms": ms16,
                            "ms_window_spread": spread16,
                            "plain_ms": plain16, "library_ms": None,
                            "gather_sdpa_ms": lib16, "bound_ms": bms16,
                            "bound_by": by16, "bound_share": bms16 / ms16,
                            "repeatable": True}}


def kernel_flash_train(dev, peaks):
    """The train step's three kernels at its attention shape: q/k/v/dO
    [8, 12, 1024, 64], causal, a key-padding bias with ragged tails on
    two rows, dropout 0.1 with a fixed seed. The backward kernels run
    from the forward's own out and lse, as in the step."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(3)
    B, N, T, D = TRAIN_BATCH, 12, TRAIN_T, 64
    rate, seed = 0.1, 1234567
    scale = 1.0 / np.sqrt(D)
    q, k, v, g = (torch.randn(B, N, T, D, generator=gen).to(dev)
                  for _ in range(4))
    kb = torch.zeros(B, T)
    kb[1, 700:] = -1e4
    kb[5, 1000:] = -1e4
    kb = kb.to(dev)
    kw = dict(causal=True, scale=scale, dropout_rate=rate)
    out, lse = fa.flash_attention_lse(q, k, v, kb, dropout_seed=seed, **kw)
    ref_out, ref_lse = fa.flash_attention_lse_plain(
        q, k, v, key_bias=kb, dropout_seed=seed, **kw)
    torch.cuda.synchronize()
    check_close("flash_fwd dropout out", out, ref_out)
    check_close("flash_fwd dropout lse", lse, ref_lse)
    fwd_err = max(max_err(out, ref_out), max_err(lse, ref_lse))
    delta = (g * out).sum(-1)
    bwd_args = (q, k, v, kb, g, lse, delta)
    bkw = dict(kw, dropout_seed=seed)
    dq = fa.flash_bwd_dq(*bwd_args, **bkw)
    dk, dv, dkb = fa.flash_bwd_dkv(*bwd_args, **bkw)
    ref_dq = fa.flash_bwd_dq_plain(*bwd_args, **bkw)
    ref_dk, ref_dv, ref_dkb = fa.flash_bwd_dkv_plain(*bwd_args, **bkw)
    torch.cuda.synchronize()
    check_close("flash_bwd_dq", dq, ref_dq, BWD_ATOL, BWD_RTOL)
    for name, got, want in (("dk", dk, ref_dk), ("dv", dv, ref_dv),
                            ("dkey_bias", dkb, ref_dkb)):
        check_close("flash_bwd_dkv " + name, got, want, BWD_ATOL, BWD_RTOL)
    dq_err = max_err(dq, ref_dq)
    dkv_err = max(max_err(dk, ref_dk), max_err(dv, ref_dv),
                  max_err(dkb, ref_dkb))
    del ref_out, ref_lse, ref_dq, ref_dk, ref_dv, ref_dkb

    fwd = lambda a, b, c, d: fa.flash_attention_lse(      # noqa: E731
        a, b, c, d, dropout_seed=seed, **kw)
    fwd_plain = lambda a, b, c, d: fa.flash_attention_lse_plain(  # noqa
        a, b, c, key_bias=d, dropout_seed=seed, **kw)
    # the plain versions hold several [8, 12, 1024, 1024] intermediates a
    # call: a shorter graph keeps the capture's memory in bounds
    rows = {}
    pairs = B * N * T * (T + 1) // 2              # causal (q, k) pairs
    tensor = 4 * B * N * T * D                    # bytes of one [B,N,T,D]
    vec = 4 * B * N * T                           # bytes of lse or delta
    kb_bytes = 4 * B * T
    causal_mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
    sdpa_mask = causal_mask[None, None] + kb.reshape(B, 1, 1, T)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, fn, plain, nbytes, flops, err, lib in (
            ("flash_fwd_dropout", fwd, fwd_plain,
             4 * tensor + kb_bytes + vec, 4 * D * pairs, fwd_err,
             lambda: sdpa(q, k, v, attn_mask=sdpa_mask, dropout_p=rate,
                          scale=scale)),
            ("flash_bwd_dq",
             lambda *a: fa.flash_bwd_dq(*a, **bkw),
             lambda *a: fa.flash_bwd_dq_plain(*a, **bkw),
             5 * tensor + kb_bytes + 2 * vec, 6 * D * pairs, dq_err, None),
            ("flash_bwd_dkv",
             lambda *a: fa.flash_bwd_dkv(*a, **bkw),
             lambda *a: fa.flash_bwd_dkv_plain(*a, **bkw),
             6 * tensor + kb_bytes + 2 * vec + 4 * B * N * T, 8 * D * pairs,
             dkv_err, None)):
        args = [(q, k, v, kb)] if name == "flash_fwd_dropout" else [bwd_args]
        ms, spread = cuda_ms(fn, args)
        plain_ms, _ = cuda_ms(plain, args, calls=3)
        bms, by = bound_ms(nbytes, flops, peaks)
        rows[name] = {"max_abs_err": err, "ms": ms, "ms_window_spread": spread,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "bound_tensor_core_ms": tf32_bound_ms(flops),
                      # SDPA draws its own dropout mask: timed eagerly,
                      # outside a graph, as milliseconds of work
                      "library_ms": event_ms(lib) if lib else None,
                      "design": FP32_DESIGN[name.replace("_dropout", "")]}
    # the backward kernels' library call: SDPA's backward alone, with the
    # same additive mask and its own dropout (dq, dk and dv in one call)
    sdpa_backward_rows(rows, sdpa, q, k, v, g, sdpa_mask, rate, scale)
    rows["shape"] = [B, N, T, D]
    rows["dropout_rate"] = rate
    rows["atol_bwd"] = BWD_ATOL
    fa.flash_attention_lse.launches = 0      # comparison launches do not count
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    return rows


def sdpa_backward_rows(rows, sdpa, q, k, v, g, mask, rate, scale):
    """SDPA's backward alone (``library_ms``, ``sdpa_bwd_ms``) and SDPA
    forward + backward (``sdpa_fwd_bwd_ms``) on the two backward rows:
    one ``backward(g, retain_graph=True)`` on a saved SDPA output with the
    same additive mask and its own dropout, the gradients dropped before
    each call so that none is accumulated."""
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        sdpa(ql, kl, vl, attn_mask=mask, dropout_p=rate,
             scale=scale).backward(g)

    yard = event_ms(sdpa_fwd_bwd)
    saved = sdpa(ql, kl, vl, attn_mask=mask, dropout_p=rate, scale=scale)

    def sdpa_bwd():
        ql.grad = kl.grad = vl.grad = None
        saved.backward(g, retain_graph=True)

    bwd = event_ms(sdpa_bwd)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[name].update(library_ms=bwd, sdpa_bwd_ms=bwd,
                          sdpa_fwd_bwd_ms=yard)


def kernel_flash_bias(dev, peaks):
    """The general-bias instantiations of the three training kernels at
    the train shape ([8, 12, 1024, 64], causal, padded key bias, dropout
    0.1): a learnable per-head bias [1, 12, 1024, 1024] (every row shared
    by the batch's 8 sequences: dbias by atomics) and a [1024, 1024] one
    (shared by all 96 heads). Each against its plain version, timed
    beside it; the yardstick is SDPA with the same float mask (bias +
    causal + padding) that requires grad, forward alone and forward +
    backward."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(4)
    B, N, T, D = TRAIN_BATCH, 12, TRAIN_T, 64
    rate, seed = 0.1, 7654321
    scale = 1.0 / np.sqrt(D)
    q, k, v, g = (torch.randn(B, N, T, D, generator=gen).to(dev)
                  for _ in range(4))
    kb = torch.zeros(B, T)
    kb[1, 700:] = -1e4
    kb[5, 1000:] = -1e4
    kb = kb.to(dev)
    kw = dict(causal=True, scale=scale, dropout_rate=rate)
    pairs = B * N * T * (T + 1) // 2
    tensor = 4 * B * N * T * D
    vec = 4 * B * N * T
    kb_bytes = 4 * B * T
    sdpa = torch.nn.functional.scaled_dot_product_attention
    causal_mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
    forms = {}
    for form, shape in (("per_head", (1, N, T, T)), ("square", (T, T))):
        bias = (torch.randn(*shape, generator=gen) * 0.5).to(dev)
        G = shape[0] * shape[1] if len(shape) == 4 else 1
        out, lse = fa.flash_attention_lse(q, k, v, kb, bias=bias,
                                          dropout_seed=seed, **kw)
        ref_out, ref_lse = fa.flash_attention_lse_plain(
            q, k, v, key_bias=kb, bias=bias, dropout_seed=seed, **kw)
        torch.cuda.synchronize()
        check_close("flash_fwd+bias %s out" % form, out, ref_out)
        check_close("flash_fwd+bias %s lse" % form, lse, ref_lse)
        fwd_err = max(max_err(out, ref_out), max_err(lse, ref_lse))
        del ref_out, ref_lse
        delta = (g * out).sum(-1)
        bwd_args = (q, k, v, kb, g, lse, delta)
        bkw = dict(kw, dropout_seed=seed, bias=bias)
        dq = fa.flash_bwd_dq(*bwd_args, **bkw)
        ref_dq = fa.flash_bwd_dq_plain(*bwd_args, **bkw)
        torch.cuda.synchronize()
        check_close("flash_bwd_dq+bias %s" % form, dq, ref_dq, BWD_ATOL,
                    BWD_RTOL)
        dq_err = max_err(dq, ref_dq)
        del dq, ref_dq
        got = fa.flash_bwd_dkv(*bwd_args, **bkw)
        want = fa.flash_bwd_dkv_plain(*bwd_args, **bkw)
        torch.cuda.synchronize()
        for name, a, b in zip(("dk", "dv", "dkey_bias", "dbias"), got, want):
            check_close("flash_bwd_dkv+dbias %s %s" % (form, name), a, b,
                        BWD_ATOL, BWD_RTOL)
        dkv_err = max(max_err(a, b) for a, b in zip(got, want))
        dbias_err = max_err(got[3], want[3])
        del got, want
        bias_bytes = 4 * G * T * T
        # SDPA with the same additive mask as a float tensor that
        # requires grad (dbias is its gradient), its own dropout
        mask = (bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
                + causal_mask + kb.reshape(B, 1, 1, T)).detach()
        ql, kl, vl, ml = (t.detach().clone().requires_grad_()
                          for t in (q, k, v, mask))

        def sdpa_fwd():
            return sdpa(ql, kl, vl, attn_mask=ml, dropout_p=rate, scale=scale)

        def sdpa_fwd_bwd():
            sdpa_fwd().backward(g)

        try:
            lib_fwd, lib_fwd_bwd = event_ms(sdpa_fwd), event_ms(sdpa_fwd_bwd)
        except RuntimeError as e:  # this PyTorch cannot run it: say so
            lib_fwd = lib_fwd_bwd = None
            lib_note = "SDPA with a grad-requiring float mask: %s" % (
                str(e).splitlines()[0][:160],)
        else:
            lib_note = None
        del ql, kl, vl, ml, mask
        rows = {}
        for name, fn, plain, nbytes, flops, err, lib, args in (
                ("flash_fwd+bias",
                 lambda a, b, c, d: fa.flash_attention_lse(
                     a, b, c, d, bias=bias, dropout_seed=seed, **kw),
                 lambda a, b, c, d: fa.flash_attention_lse_plain(
                     a, b, c, key_bias=d, bias=bias, dropout_seed=seed,
                     **kw),
                 4 * tensor + kb_bytes + vec + bias_bytes, 4 * D * pairs,
                 fwd_err, lib_fwd, [(q, k, v, kb)]),
                ("flash_bwd_dq+bias",
                 lambda *a: fa.flash_bwd_dq(*a, **bkw),
                 lambda *a: fa.flash_bwd_dq_plain(*a, **bkw),
                 5 * tensor + kb_bytes + 2 * vec + bias_bytes, 6 * D * pairs,
                 dq_err, None, [bwd_args]),
                ("flash_bwd_dkv+dbias",
                 lambda *a: fa.flash_bwd_dkv(*a, **bkw),
                 lambda *a: fa.flash_bwd_dkv_plain(*a, **bkw),
                 6 * tensor + kb_bytes + 2 * vec + 4 * B * N * T
                 + 2 * bias_bytes, 8 * D * pairs, dkv_err, None,
                 [bwd_args])):
            ms, spread = cuda_ms(fn, args)
            plain_ms, _ = cuda_ms(plain, args, calls=3)
            bms, by = bound_ms(nbytes, flops, peaks)
            rows[name] = {"max_abs_err": err, "ms": ms,
                          "ms_window_spread": spread, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": by,
                          "bound_tensor_core_ms": tf32_bound_ms(flops),
                          "library_ms": lib,
                          "sdpa_fwd_bwd_ms": lib_fwd_bwd}
            if lib_note:
                rows[name]["library_note"] = lib_note
        rows["flash_bwd_dkv+dbias"]["dbias_max_abs_err"] = dbias_err
        forms[form] = {"bias_shape": list(shape), "rows": G,
                       "kernels": rows}
        torch.cuda.empty_cache()
    fa.flash_attention_lse.launches = 0      # comparison launches do not count
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0
    return {"shape": [B, N, T, D], "dropout_rate": rate, "causal": True,
            "atol_fwd": KERNEL_ATOL, "atol_bwd": BWD_ATOL, "forms": forms}


def check_low_precision(name, dtype, q, k, v, kb, g, rate, seed, bias=None,
                        causal=True):
    """The three training kernels on ``dtype`` inputs against their plain
    versions at the limits of ``tools/lowp_limits.py``; returns
    ({"fwd", "dq", "dkv"}: max abs err, "ratios": each output's readings
    over its limits}, (out, lse, delta))."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.tools import lowp_limits as lowp

    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=seed, bias=bias)
    out, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, key_bias=kb,
                                                    **kw)
    torch.cuda.synchronize()
    if out.dtype != dtype or lse.dtype != torch.float32:
        raise AssertionError("%s: out %s, lse %s" % (name, out.dtype,
                                                     lse.dtype))
    bound = lowp.out_bound(dtype, q, k, v, ref_out, key_bias=kb, **kw)
    ratios = {"out": lowp.out_ratios(dtype, out, ref_out, bound)}
    lowp.check("%s out" % name, ratios["out"])
    check_close("%s lse" % name, lse, ref_lse, lowp.FP32_ATOL, lowp.FP32_ATOL)
    errs = {"fwd": max(max_err(out, ref_out), max_err(lse, ref_lse)),
            "ratios": ratios}
    del ref_out, ref_lse, bound
    delta = (g.float() * out.float()).sum(-1)
    bwd_args = (q, k, v, kb, g, lse, delta)
    dq = fa.flash_bwd_dq(*bwd_args, **kw)
    ref_dq = fa.flash_bwd_dq_plain(*bwd_args, **kw)
    torch.cuda.synchronize()
    got = fa.flash_bwd_dkv(*bwd_args, **kw)
    want = fa.flash_bwd_dkv_plain(*bwd_args, **kw)
    torch.cuda.synchronize()
    bounds = dict(zip(("dq", "dk", "dv"), lowp.grad_bounds(
        dtype, *bwd_args, (ref_dq,) + tuple(want[:2]), **kw)))
    ratios["dq"] = lowp.grad_ratios(dtype, dq, ref_dq, bounds["dq"])
    lowp.check("%s dq" % name, ratios["dq"])
    errs["dq"] = max_err(dq, ref_dq)
    del dq, ref_dq
    errs["dkv"] = 0.0
    for oname, a, b in zip(("dk", "dv", "dkey_bias", "dbias"), got, want):
        low = oname in ("dk", "dv")
        if (a.dtype == dtype) != low:
            raise AssertionError("%s %s comes back %s" % (name, oname,
                                                          a.dtype))
        if low:
            ratios[oname] = lowp.grad_ratios(dtype, a, b, bounds[oname])
            lowp.check("%s %s" % (name, oname), ratios[oname])
        else:
            check_close("%s %s" % (name, oname), a, b, lowp.FP32_ATOL,
                        lowp.FP32_ATOL)
        errs["dkv"] = max(errs["dkv"], max_err(a, b))
    del got, want, bounds
    return errs, (out, lse, delta)


def kernel_flash_train_bf16(dev, peaks):
    """The bf16 forms of the three training kernels at the AMP train
    step's attention shape (q/k/v/dO [8, 12, 1024, 64] bf16, causal, the
    padded key bias, dropout 0.1), each against its plain version on the
    same bf16 inputs, timed beside it; the bound counts bf16 bytes over
    the memory rate against the FLOPs over the bf16 tensor-core peak.
    The library yardstick is SDPA in bf16 with the same mask and its own
    dropout (forward; its backward alone for the backward kernels, with
    forward + backward beside it)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(6)
    B, N, T, D = TRAIN_BATCH, 12, TRAIN_T, 64
    rate, seed = 0.1, 1357911
    scale = 1.0 / np.sqrt(D)
    dt = torch.bfloat16
    q, k, v, g = (torch.randn(B, N, T, D, generator=gen).to(dev, dt)
                  for _ in range(4))
    kb = torch.zeros(B, T)
    kb[1, 700:] = -1e4
    kb[5, 1000:] = -1e4
    kb = kb.to(dev)
    errs, (out, lse, delta) = check_low_precision(
        "bf16", dt, q, k, v, kb, g, rate, seed)
    kw = dict(causal=True, scale=scale, dropout_rate=rate,
              dropout_seed=seed)
    bwd_args = (q, k, v, kb, g, lse, delta)
    pairs = B * N * T * (T + 1) // 2
    tensor = 2 * B * N * T * D                    # bytes of one bf16 tensor
    vec = 4 * B * N * T
    kb_bytes = 4 * B * T
    causal_mask = torch.full((T, T), float("-inf"), device=dev).triu(1)
    sdpa_mask = (causal_mask[None, None] + kb.reshape(B, 1, 1, T)).to(dt)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, fn, plain, nbytes, flops, err, lib, args in (
            ("flash_fwd",
             lambda a, b, c, d: fa.flash_attention_lse(a, b, c, d, **kw),
             lambda a, b, c, d: fa.flash_attention_lse_plain(
                 a, b, c, key_bias=d, **kw),
             4 * tensor + kb_bytes + vec, 4 * D * pairs, errs["fwd"],
             lambda: sdpa(q, k, v, attn_mask=sdpa_mask, dropout_p=rate,
                          scale=scale), [(q, k, v, kb)]),
            ("flash_bwd_dq", lambda *a: fa.flash_bwd_dq(*a, **kw),
             lambda *a: fa.flash_bwd_dq_plain(*a, **kw),
             5 * tensor + kb_bytes + 2 * vec, 6 * D * pairs, errs["dq"],
             None, [bwd_args]),
            ("flash_bwd_dkv", lambda *a: fa.flash_bwd_dkv(*a, **kw),
             lambda *a: fa.flash_bwd_dkv_plain(*a, **kw),
             6 * tensor + kb_bytes + 2 * vec + 4 * B * N * T, 8 * D * pairs,
             errs["dkv"], None, [bwd_args])):
        ms, spread = cuda_ms(fn, args)
        plain_ms, _ = cuda_ms(plain, args, calls=3)
        bms, by = bound_ms(nbytes, flops, peaks, BF16_PEAK)
        rows[name] = {"max_abs_err": err, "ms": ms, "ms_window_spread": spread,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": event_ms(lib) if lib else None}
    rows["limit_ratios"] = errs["ratios"]
    sdpa_backward_rows(rows, sdpa, q, k, v, g, sdpa_mask, rate, scale)
    for name, r in rows.items():
        if not isinstance(r, dict) or "ms" not in r:
            continue
        r["design"] = BF16_DESIGN[name]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        # forward: against SDPA's forward; backward kernels: against
        # SDPA's backward alone, which returns dq, dk and dv together
        r["sdpa_ratio"] = r["ms"] / r["library_ms"]
    rows["shape"] = [B, N, T, D]
    rows["dtype"] = "bf16"
    rows["dropout_rate"] = rate
    zero_flash_launches()          # comparison launches do not count
    return rows


def bert_lengths(batch, seq, seed):
    """Each row's real length, drawn from the seed between
    ``seq * BERT_MIN_LEN / BERT_SEQ`` and ``seq``."""
    rng = np.random.default_rng(seed)
    return rng.integers(seq * BERT_MIN_LEN // BERT_SEQ, seq + 1, batch)


def kernel_flash_bert(dev, peaks):
    """The three training kernels at the BERT-base classifier's attention
    shape: q/k/v/dO [24, 12, 384, 64], non-causal, a ragged key-padding
    bias (``bert_lengths``), dropout 0.1 (``kernel_flash_form``)."""
    return kernel_flash_form(dev, peaks, "bert", BERT_BATCH, 12, BERT_SEQ,
                             BERT_SEQ, bert_lengths(BERT_BATCH, BERT_SEQ,
                                                    seed=9), 0.1, seed=9)


def kernel_flash_nmt(dev, peaks):
    """The three training kernels at the Transformer NMT's cross form
    (``nmt`` phase): q/dO [64, 8, 48, 64] against k/v [64, 8, 64, 64],
    non-causal, a ragged source key-padding bias (``nmt_lengths``),
    dropout 0 as the phase trains (``kernel_flash_form``)."""
    return kernel_flash_form(
        dev, peaks, "nmt cross", NMT_BATCH, 8, NMT_TGT, NMT_SRC,
        nmt_lengths(NMT_BATCH, NMT_SRC, seed=11), 0.0, seed=11)


def kernel_flash_form(dev, peaks, tag, B, N, Sq, Sk, lens, rate, seed):
    """The three training kernels at one non-causal form, q/dO [B, N, Sq,
    64] against k/v [B, N, Sk, 64] under a key-padding bias (-1e4 past
    each row's ``lens``), in fp32 (held to the kernel limits) and in bf16
    (held to ``lowp_limits``), the backward kernels from the forward's own
    out and lse. Each is timed beside its plain version, its bound (every
    (q, k) pair: the kernels do not skip masked keys) and SDPA given the
    key-padding mask (its backward alone for the backward kernels,
    forward + backward beside it)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(seed)
    D = 64
    dseed = 2468013
    scale = 1.0 / np.sqrt(D)
    kb = torch.zeros(B, Sk)
    for i, n in enumerate(lens):
        kb[i, n:] = -1e4
    kb = kb.to(dev)
    pairs = B * N * Sq * Sk                        # non-causal
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"shape": [B, N, Sq, D], "causal": False, "dropout_rate": rate}
    if Sk != Sq:
        out["kv_shape"] = [B, N, Sk, D]
    for tname, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, g = (torch.randn(B, N, S, D, generator=gen).to(dev, dt)
                      for S in (Sq, Sk, Sk, Sq))
        kw = dict(causal=False, scale=scale, dropout_rate=rate,
                  dropout_seed=dseed)
        if dt == torch.float32:
            o, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
            ref_o, ref_lse = fa.flash_attention_lse_plain(
                q, k, v, key_bias=kb, **kw)
            torch.cuda.synchronize()
            check_close("%s flash_fwd out" % tag, o, ref_o)
            check_close("%s flash_fwd lse" % tag, lse, ref_lse)
            errs = {"fwd": max(max_err(o, ref_o), max_err(lse, ref_lse))}
            del ref_o, ref_lse
            delta = (g * o).sum(-1)
            bwd_args = (q, k, v, kb, g, lse, delta)
            dq = fa.flash_bwd_dq(*bwd_args, **kw)
            ref_dq = fa.flash_bwd_dq_plain(*bwd_args, **kw)
            torch.cuda.synchronize()
            check_close("%s flash_bwd_dq" % tag, dq, ref_dq, BWD_ATOL,
                        BWD_RTOL)
            errs["dq"] = max_err(dq, ref_dq)
            del dq, ref_dq
            got = fa.flash_bwd_dkv(*bwd_args, **kw)
            want = fa.flash_bwd_dkv_plain(*bwd_args, **kw)
            torch.cuda.synchronize()
            errs["dkv"] = 0.0
            for oname, a, b in zip(("dk", "dv", "dkey_bias"), got, want):
                check_close("%s flash_bwd_dkv %s" % (tag, oname), a, b,
                            BWD_ATOL, BWD_RTOL)
                errs["dkv"] = max(errs["dkv"], max_err(a, b))
            del got, want
            esize, rate_peak = 4, None
        else:
            errs, (o, lse, delta) = check_low_precision(
                "%s bf16" % tag, dt, q, k, v, kb, g, rate, dseed,
                causal=False)
            bwd_args = (q, k, v, kb, g, lse, delta)
            esize, rate_peak = 2, BF16_PEAK
        tq = esize * B * N * Sq * D
        tk = esize * B * N * Sk * D
        vec = 4 * B * N * Sq
        kb_bytes = 4 * B * Sk
        sdpa_mask = kb.reshape(B, 1, 1, Sk).to(dt)
        rows = {}
        for name, fn, plain, nbytes, flops, err, lib, args in (
                ("flash_fwd",
                 lambda a, b, c, d: fa.flash_attention_lse(a, b, c, d, **kw),
                 lambda a, b, c, d: fa.flash_attention_lse_plain(
                     a, b, c, key_bias=d, **kw),
                 2 * tq + 2 * tk + kb_bytes + vec, 4 * D * pairs,
                 errs["fwd"],
                 lambda: sdpa(q, k, v, attn_mask=sdpa_mask, dropout_p=rate,
                              scale=scale), [(q, k, v, kb)]),
                ("flash_bwd_dq", lambda *a: fa.flash_bwd_dq(*a, **kw),
                 lambda *a: fa.flash_bwd_dq_plain(*a, **kw),
                 3 * tq + 2 * tk + kb_bytes + 2 * vec, 6 * D * pairs,
                 errs["dq"], None, [bwd_args]),
                ("flash_bwd_dkv", lambda *a: fa.flash_bwd_dkv(*a, **kw),
                 lambda *a: fa.flash_bwd_dkv_plain(*a, **kw),
                 2 * tq + 4 * tk + kb_bytes + 2 * vec + 4 * B * N * Sk,
                 8 * D * pairs, errs["dkv"], None, [bwd_args])):
            ms, spread = cuda_ms(fn, args)
            plain_ms, _ = cuda_ms(plain, args, calls=3)
            bms, by = bound_ms(nbytes, flops, peaks, rate_peak)
            rows[name] = {"max_abs_err": err, "ms": ms,
                          "ms_window_spread": spread, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": by,
                          "library_ms": event_ms(lib) if lib else None}
            if dt == torch.float32:
                rows[name]["bound_tensor_core_ms"] = tf32_bound_ms(flops)
        sdpa_backward_rows(rows, sdpa, q, k, v, g, sdpa_mask, rate, scale)
        for name, r in rows.items():
            r["bound_share"] = r["bound_ms"] / r["ms"]
            r["sdpa_ratio"] = r["ms"] / r["library_ms"]
        if "ratios" in errs:
            rows["limit_ratios"] = errs["ratios"]
        out[tname] = rows
        del q, k, v, g, o, lse, delta, bwd_args
        torch.cuda.empty_cache()
    zero_flash_launches()          # comparison launches do not count
    return out


def kernel_other_forms(dev):
    """fp16 once at a small shape (with a general bias), bf16 at a ragged
    one, and a head dim of 48 (not instantiated: the training kernels pad
    it to 64, the decode kernels have a D = 48 instantiation) on all five
    kernels in fp32; then both decode kernels at D = 200 and 256 and at
    the ragged D = 20 and 3, in fp32 and bf16; each against its plain
    version. Returns max abs errors (bf16 decode: out_bound ratios) by
    check."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator().manual_seed(7)
    out = {}
    B, N, S = 2, 3, 130
    kb = torch.zeros(B, S)
    kb[1, 100:] = -1e4
    kb = kb.to(dev)
    for name, dt, D, bias in (("fp16_d64_bias", torch.float16, 64, True),
                              ("bf16_d48_bias", torch.bfloat16, 48, True),
                              ("fp16_d128", torch.float16, 128, False)):
        q, k, v, g = (torch.randn(B, N, S, D, generator=gen).to(dev, dt)
                      for _ in range(4))
        gb = ((torch.randn(1, N, S, S, generator=gen) * 0.5).to(dev)
              if bias else None)
        errs, _res = check_low_precision(name, dt, q, k, v, kb, g, 0.1, 99,
                                         bias=gb)
        out[name] = errs
    # D = 48, fp32, the training kernels (padded to 64) ...
    D = 48
    q, k, v, g = (torch.randn(B, N, S, D, generator=gen).to(dev)
                  for _ in range(4))
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=5)
    o, lse = fa.flash_attention_lse(q, k, v, kb, **kw)
    ro, rl = fa.flash_attention_lse_plain(q, k, v, key_bias=kb, **kw)
    grads = fa.flash_attention_bwd_from_residuals(q, k, v, kb, 5, o, lse, g,
                                                  causal=True,
                                                  dropout_rate=0.1)
    ref = fa.flash_attention_bwd_plain(q, k, v, kb, 5, o, lse, g, causal=True,
                                       dropout_rate=0.1)
    torch.cuda.synchronize()
    check_close("flash_fwd D=48 out", o, ro)
    check_close("flash_fwd D=48 lse", lse, rl)
    for n, a, b in zip(("dq", "dk", "dv", "dkey_bias"), grads, ref):
        check_close("flash_bwd D=48 " + n, a, b, BWD_ATOL, BWD_RTOL)
    out["fp32_d48_train"] = {"fwd": max(max_err(o, ro), max_err(lse, rl)),
                             "bwd": max(max_err(a, b)
                                        for a, b in zip(grads, ref))}
    # ... and the decode kernels (D = 48: the ring's run-time-D form)
    q1 = torch.randn(B, N, 1, D, generator=gen).to(dev)
    dec = fa.flash_decode_attention(q1, k, v, kb)
    rdec = fa.flash_decode_attention_plain(q1, k, v, key_bias=kb)
    blk, MB = 16, 9
    pool_k, pool_v = (torch.randn(B * MB + 1, N, blk, D, generator=gen)
                      .to(dev) for _ in range(2))
    tables = (torch.randperm(B * MB, generator=gen) + 1).reshape(B, MB)
    tables = tables.to(torch.int32).to(dev)
    pkb = torch.zeros(B, MB * blk)
    pkb[0, 50:] = -1e4
    pkb = pkb.to(dev)
    pdec = fa.flash_decode_paged_attention(q1, pool_k, pool_v, tables, pkb)
    rpdec = fa.flash_decode_paged_attention_plain(q1, pool_k, pool_v, tables,
                                                  key_bias=pkb)
    torch.cuda.synchronize()
    check_close("flash_decode D=48", dec, rdec)
    check_close("flash_decode_paged D=48", pdec, rpdec)
    out["fp32_d48_decode"] = {"flash_decode": max_err(dec, rdec),
                              "flash_decode_paged": max_err(pdec, rpdec)}
    # the decode kernels past D = 128 (two pieces a lane in fp32) and off
    # the multiples of 8 (bf16 at D = 20 and both types at D = 3 take the
    # element path), fp32 at the kernel tolerance and bf16 within
    # lowp_limits.out_bound
    S = 300
    for D in (200, 256, 20, 3):
        for dt in (torch.float32, torch.bfloat16):
            q1 = torch.randn(B, N, 1, D, generator=gen).to(dev, dt)
            k, v = (torch.randn(B, N, S, D, generator=gen).to(dev, dt)
                    for _ in range(2))
            dkb = torch.zeros(B, S)
            dkb[1, 111:] = -1e4
            dkb = dkb.to(dev)
            MB = (S + blk - 1) // blk
            pools = [torch.randn(B * MB + 1, N, blk, D, generator=gen)
                     .to(dev, dt) for _ in range(2)]
            tables = (torch.randperm(B * MB, generator=gen) + 1).reshape(
                B, MB).to(torch.int32).to(dev)
            pkb = torch.zeros(B, MB * blk)
            pkb[0, 50:] = -1e4
            pkb = pkb.to(dev)
            dec = fa.flash_decode_attention(q1, k, v, dkb)
            rdec = fa.flash_decode_attention_plain(q1, k, v, key_bias=dkb)
            pdec = fa.flash_decode_paged_attention(q1, pools[0], pools[1],
                                                   tables, pkb)
            rpdec = fa.flash_decode_paged_attention_plain(
                q1, pools[0], pools[1], tables, key_bias=pkb)
            torch.cuda.synchronize()
            name = "%s_d%d_decode" % ("fp32" if dt == torch.float32
                                      else "bf16", D)
            if dt == torch.float32:
                check_close("flash_decode D=%d" % D, dec, rdec)
                check_close("flash_decode_paged D=%d" % D, pdec, rpdec)
                out[name] = {"flash_decode": max_err(dec, rdec),
                             "flash_decode_paged": max_err(pdec, rpdec)}
            else:
                rows = [fa.gather_paged_rows(x, tables) for x in pools]
                scale = 1.0 / np.sqrt(D)
                out[name] = {
                    "flash_decode_out_bound_ratio": decode_lowp_ratio(
                        "flash_decode[bf16] D=%d" % D, dec, rdec, q1, k, v,
                        dkb, scale),
                    "flash_decode_paged_out_bound_ratio": decode_lowp_ratio(
                        "flash_decode_paged[bf16] D=%d" % D, pdec, rpdec, q1,
                        rows[0], rows[1], pkb, scale)}
    zero_flash_launches()
    fa.flash_decode_attention.launches = 0
    fa.flash_decode_paged_attention.launches = 0
    return out


# ---------------------------------------------------------------------------
# phase 4: the engine
# ---------------------------------------------------------------------------


def make_recording_engine():
    from paddle_tpu_torch.serving import decode

    class RecordingStream(decode.GenerationStream):
        """Keeps every logits row the engine picked a token from."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.seen_logits = []
            self.push_times = []

        def pick(self, logits):
            self.seen_logits.append(np.array(logits, dtype=np.float32))
            return super().pick(logits)

        def _push(self, tok):
            self.push_times.append(time.perf_counter())
            super()._push(tok)

    class RecordingEngine(decode.DecodeEngine):
        stream_class = RecordingStream

    return RecordingEngine


def make_prompts(model, prompt_lens, seed=1):
    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    return [rng.integers(0, vocab, n).tolist() for n in prompt_lens]


def drive(engine, prompts, new_tokens):
    """Submit greedy requests to a started engine; the second half is
    submitted once the first stream is decoding, so it joins mid-flight.
    Returns (streams, seconds, tokens the first stream had when the
    second half joined)."""
    from paddle_tpu_torch.fluid import profiler

    profiler.reset_histograms()
    t0 = time.perf_counter()
    half = len(prompts) // 2
    streams = [engine.submit(p, max_new_tokens=new_tokens)
               for p in prompts[:half]]
    deadline = time.monotonic() + 300
    while len(streams[0]._tokens) < 4 and not streams[0].done:
        if time.monotonic() > deadline:
            raise TimeoutError("first stream never started decoding")
        time.sleep(0.001)
    joined_at = len(streams[0]._tokens)
    streams += [engine.submit(p, max_new_tokens=new_tokens)
                for p in prompts[half:]]
    for s in streams:
        s.tokens(timeout=600)
    return streams, time.perf_counter() - t0, joined_at


def serve(model, prompt_lens, new_tokens, slots, max_len, seed=1):
    """The contiguous engine's run: launch counts zeroed just before the
    engine is built, read just after its requests finish. Returns
    (streams, stats, launches, seconds)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    prompts = make_prompts(model, prompt_lens, seed)
    fa.flash_attention_lse.launches = 0
    fa.flash_decode_attention.launches = 0
    engine = make_recording_engine()(model, slots=slots, max_len=max_len)
    engine.start()
    try:
        streams, seconds, joined_at = drive(engine, prompts, new_tokens)
        launches = {"flash_fwd": fa.flash_attention_lse.launches,
                    "flash_decode": fa.flash_decode_attention.launches}
        stats = engine.stats()
    finally:
        engine.stop()
    stats["joined_after_tokens"] = joined_at
    return streams, stats, launches, seconds


def check_streams(streams, new_tokens):
    for s in streams:
        if len(s.tokens()) != new_tokens or s.finish_reason != "length":
            raise AssertionError("stream ended early: %d tokens, %s"
                                 % (len(s.tokens()), s.finish_reason))


def teacher_forced_check(model, streams):
    """Run the plain full forward (dense attention, no kernels) along
    each stream's own tokens; every step's logits must agree and every
    emitted token must be the reference's argmax or within tolerance of
    it. Returns (max logit error, exact-argmax share)."""
    dev = model.device
    worst, exact, total = 0.0, 0, 0
    with torch.inference_mode():
        for s in streams:
            # a resumed stream picked its tokens after prompt + resume
            prompt = s.prompt_ids + getattr(s, "resume_tokens", [])
            P, gen = len(prompt), s.tokens()
            seq = prompt + gen[:-1]
            L = len(seq)
            ids = torch.tensor([seq], device=dev)
            pos = torch.arange(L, device=dev)[None]
            mask = torch.ones(1, L, device=dev)
            ref = model(ids, pos, mask, use_flash=False)[0, P - 1:]
            ref = ref.float().cpu().numpy()
            got = np.stack(s.seen_logits)
            if got.shape != ref.shape:
                raise AssertionError("stream logged %s logits rows, "
                                     "reference %s" % (got.shape, ref.shape))
            if not np.isfinite(got).all():
                raise AssertionError("non-finite engine logits")
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            if err > LOGIT_ATOL:
                raise AssertionError("engine logits off the reference by "
                                     "%.3g (tolerance %g)" % (err, LOGIT_ATOL))
            for i, tok in enumerate(gen):
                if ref[i, tok] < ref[i].max() - LOGIT_ATOL:
                    raise AssertionError(
                        "emitted token %d at step %d is not the reference "
                        "argmax %d" % (tok, i, int(ref[i].argmax())))
                exact += int(tok == int(ref[i].argmax()))
                total += 1
    return worst, exact / max(total, 1)


def _kernel_class(name):
    """A device kernel's class by its name: the port's flash kernels,
    matrix products (cuBLAS's ``*gemm*`` kernels and its Hopper ``nvjet``
    ones), PyTorch's copy kernel (dtype casts and layout copies), and
    everything else."""
    low = name.lower()
    if "flash_" in name:
        return "flash"
    if "gemm" in low or "nvjet" in low:
        return "gemm"
    if "copy_kernel" in low:
        return "copy"
    return "other"


# The PyTorch ops that run one cuBLAS matrix product each: their host-side
# records count the GEMMs a step asks for, whatever the device trace kept
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::addbmm", "aten::mv", "aten::addmv", "aten::dot",
            "aten::_addmm_activation")


def _profile(fn, reps):
    """Wall ms per call of ``fn`` (host clock, unprofiled, ending in a
    synchronize), then ``reps`` calls under torch.profiler for the
    device-busy ms per call (kernel and copy time; one stream, so nothing
    overlaps), split by ``_kernel_class``, and the top device ops. The idle share compares the two:
    the profiler itself slows the host, so its own wall time is reported
    apart and not used. ``gemm_op_calls`` counts the ops that ask for
    the GEMMs on the host; the device records can fall short of them
    (``program_train_phase``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev_events = []
    gemm_ops = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in GEMM_OPS:
            gemm_ops[e.key] = e.count / reps
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        dev_events.append((us / reps, e.count / reps, e.key))
    busy_ms = sum(us for us, _n, _k in dev_events) / 1e3
    dev_events.sort(reverse=True)
    by_class = {"gemm": 0.0, "flash": 0.0, "copy": 0.0, "other": 0.0}
    launches_by_class = dict(by_class)
    gemm_kernels = {}
    gemm_calls = {}
    flash_ms = {}
    flash_calls = {}
    for us, n, key in dev_events:
        cls = _kernel_class(key)
        by_class[cls] += us / 1e3
        launches_by_class[cls] += n
        if cls == "gemm":
            gemm_kernels[key[:100]] = gemm_kernels.get(key[:100], 0.0) + us
            gemm_calls[key[:100]] = gemm_calls.get(key[:100], 0.0) + n
        if cls == "flash":
            base = re.search(r"(flash_\w+?)_kernel", key)
            base = base.group(1) if base else key[:60]
            flash_ms[base] = flash_ms.get(base, 0.0) + us / 1e3
            flash_calls[base] = flash_calls.get(base, 0.0) + n
    return {
        "wall_ms": wall_ms, "wall_ms_under_profiler": profiled_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ms_by_class": by_class,
        "launches_per_call": sum(n for _us, n, _k in dev_events),
        "launches_by_class": launches_by_class,
        "gemm_kernels_us": dict(sorted(gemm_kernels.items(),
                                       key=lambda kv: -kv[1])[:6]),
        "gemm_kernel_calls": gemm_calls,
        "gemm_op_calls": gemm_ops,
        "kernel_calls": {k: n for _us, n, k in dev_events},
        "top_other": [{"kernel": k[:90], "us": us, "calls": n}
                      for us, n, k in dev_events
                      if _kernel_class(k) == "other"][:6],
        "flash_kernels": sorted({k[:90] for _us, _n, k in dev_events
                                 if "flash_" in k}),
        "flash_ms_by_kernel": flash_ms,
        "flash_launches_by_kernel": flash_calls,
        "top": [{"kernel": k[:70], "us": us, "calls": n}
                for us, n, k in dev_events[:8]],
    }


def profile_phase(model):
    """Where a decode step and a prefill spend their time at the served
    shape: 8 active slots at cache position 500, and a 990-token prompt
    (bucket 1024)."""
    from paddle_tpu_torch.serving import decode

    sess = decode.DecodeSession(model, slots=8, max_len=1024)
    slots = sess.slots
    prompt = list(range(1, 991))
    step = _profile(lambda: sess.decode_step([1] * slots, [500] * slots,
                                             [True] * slots), reps=10)
    prefill = _profile(lambda: sess.prefill(0, prompt), reps=3)
    del sess
    # the paged engine's steps at the same positions: each slot's table
    # its own 64 blocks of the pool
    psess = decode.DecodeSession(model, slots=8, max_len=PAGED_MAX_LEN,
                                 block_size=PAGED_BLOCK, spec_tokens=SPEC_K)
    mb = psess.max_blocks
    tables = [list(range(1 + s * mb, 1 + (s + 1) * mb)) for s in range(slots)]
    paged = {}
    for width in (1, SPEC_K):
        toks = np.ones((slots, width), "int64")
        paged[width] = _profile(
            lambda: psess.paged_step(toks, [500] * slots, tables,
                                     [True] * slots, width=width), reps=10)
    # each decode step launches its decode kernel once a layer: the
    # split-K merge adds no launch
    n_layers = model.cfg.num_layers
    decode_flash = {}
    for path, prof, kname in (("decode_step", step, "flash_decode"),
                              ("paged_step_width1", paged[1],
                               "flash_decode_paged")):
        n = prof["flash_launches_by_kernel"].get(kname, 0.0)
        if n != n_layers:
            raise AssertionError("%s launched %s times a %s, not %d"
                                 % (kname, n, path, n_layers))
        decode_flash[path] = {
            "kernel": kname, "device_ms": prof["flash_ms_by_kernel"][kname],
            "launches_per_step": n,
            "all_launches_per_step": prof["launches_per_call"]}
    return {"phase": "profile", "decode_step": step, "prefill_990": prefill,
            "paged_step_width1": paged[1],
            "paged_verify_width%d" % SPEC_K: paged[SPEC_K],
            "decode_flash": decode_flash}


def engine_phase(dev):
    from paddle_tpu_torch.fluid import profiler

    t0 = time.perf_counter()
    model = gpt2_small(dev)
    cfg = model.cfg
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    streams, stats, launches, seconds = serve(
        model, PROMPT_LENS, NEW_TOKENS, slots=8, max_len=1024)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if stats["joined_after_tokens"] >= NEW_TOKENS:
        raise AssertionError("late requests did not join mid-flight")
    n_layers = cfg.num_layers
    if launches["flash_fwd"] < n_layers * stats["prefills"]:
        raise AssertionError("flash_fwd launched %d times for %d prefills"
                             % (launches["flash_fwd"], stats["prefills"]))
    if launches["flash_decode"] < n_layers * stats["steps"]:
        raise AssertionError("flash_decode launched %d times for %d steps"
                             % (launches["flash_decode"], stats["steps"]))
    check_streams(streams, NEW_TOKENS)
    logit_err, exact_share = teacher_forced_check(model, streams)
    step = profiler.summarize_histogram("decode_step_ms")
    tokens = sum(len(s.tokens()) for s in streams)
    return model, {
        "phase": "engine", "model": "gpt2-small", "slots": 8,
        "max_len": 1024, "requests": len(streams),
        "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
        "weights_load_s": load_s, "serve_s": seconds,
        "tokens_per_s": tokens / seconds,
        "decode_step_ms_mean": step["mean"], "decode_step_ms_p50": step["p50"],
        "decode_steps": step["count"],
        "ttft_ms_mean": float(np.mean([s.ttft_ms for s in streams])),
        "peak_mem_mib": peak_mib, "stats": stats, "launches": launches,
        "teacher_forced_max_logit_err": logit_err,
        "logit_atol": LOGIT_ATOL, "exact_argmax_share": exact_share,
    }, launches


def wait_tokens(streams, n, timeout=300):
    """Block until every stream has emitted at least ``n`` tokens."""
    deadline = time.monotonic() + timeout
    while any(len(s._tokens) < n and not s.done for s in streams):
        if time.monotonic() > deadline:
            raise TimeoutError("streams never reached %d tokens" % n)
        time.sleep(0.001)


def span_ms(spans):
    ms = [(s["end"] - s["start"]) * 1e3 for s in spans]
    return {"count": len(ms), "mean": float(np.mean(ms)),
            "p50": float(np.median(ms)), "max": float(np.max(ms))}


def engine_features_phase(model):
    """The contiguous engine with the prefix store and 256-token windows
    at GPT-2 small: a prefix run (one miss publishes the system prompt,
    seven hits copy it), a chunked admission beside live streams, a
    resume, and a preemption run. Launch counts are zeroed just before
    the engine is built and read after the last run; every emitted
    token is held teacher-forced against the plain full forward."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.observability import trace

    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(7)

    def tokens(n):
        return rng.integers(0, vocab, n).tolist()

    system = tokens(SYSTEM_LEN)
    torch.cuda.reset_peak_memory_stats()
    trace.reset()
    c0 = profiler.get_counters()
    fa.flash_attention_lse.launches = 0
    fa.flash_decode_attention.launches = 0
    engine = make_recording_engine()(
        model, slots=8, max_len=1024, prefix_cache_mb=FEATURE_PREFIX_MB,
        prefill_chunk=FEATURE_CHUNK)
    t0 = time.perf_counter()
    engine.start()
    t_served = time.perf_counter()
    runs = {}
    try:
        if engine.session.prefix_blocks != FEATURE_BLOCKS:
            raise AssertionError("prefix store of %d blocks, not %d"
                                 % (engine.session.prefix_blocks,
                                    FEATURE_BLOCKS))
        # run 1: the first request misses and publishes the system
        # prompt's blocks; the other seven hit them
        first = engine.submit(system + tokens(SUFFIX_LENS[0]),
                              max_new_tokens=NEW_TOKENS)
        wait_tokens([first], 1)
        published = engine.stats()["prefix_store"]["cached_blocks"]
        hits = [engine.submit(system + tokens(n), max_new_tokens=NEW_TOKENS)
                for n in SUFFIX_LENS[1:]]
        prefix_run = [first] + hits
        for s in prefix_run:
            s.tokens(timeout=600)
        cached = [s.cached_prefix_tokens for s in prefix_run]
        if published != SYSTEM_LEN // 64 or cached != [0] + [SYSTEM_LEN] * 7:
            raise AssertionError("prefix run: %d blocks published, cached "
                                 "tokens %r" % (published, cached))
        runs["prefix"] = {
            "published_blocks": published, "cached_prefix_tokens": cached,
            "admit_windows": [s.admit_windows for s in prefix_run],
            "ttft_miss_ms": first.ttft_ms,
            "ttft_hit_ms": [s.ttft_ms for s in hits],
            "ttft_hit_ms_min": min(s.ttft_ms for s in hits)}

        # run 2: a 990-token prompt admits one window a tick while four
        # streams decode
        live = [engine.submit(tokens(n), max_new_tokens=LIVE_NEW)
                for n in LIVE_LENS]
        wait_tokens(live, 4)
        t_long = time.perf_counter()
        long_ = engine.submit(tokens(CHUNKED_LEN), max_new_tokens=NEW_TOKENS)
        for s in live + [long_]:
            s.tokens(timeout=600)
        wins = [sp for sp in trace.get_spans()
                if sp["name"] == "decode_resume_prefill"
                and sp["start"] > t_long]
        rows = [sp["args"]["rows"] for sp in wins]
        if long_.admit_windows != 4 or rows != [256, 256, 256, 222]:
            raise AssertionError("990-token admission: %d windows of %r"
                                 % (long_.admit_windows, rows))
        between = [min(sum(a["end"] < t < b["start"] for t in s.push_times)
                       for s in live) for a, b in zip(wins, wins[1:])]
        if min(between) < 1:
            raise AssertionError("a live stream emitted nothing between two "
                                 "windows: %r" % (between,))
        # the live streams' gaps between tokens that overlap the
        # admission: each holds one window and one step
        gaps = [(t - u) * 1e3 for s in live
                for u, t in zip(s.push_times, s.push_times[1:])
                if u < wins[-1]["end"] and t > wins[0]["start"]]
        runs["chunked"] = {
            "admit_windows": long_.admit_windows, "window_rows": rows,
            "window_ms": [(sp["end"] - sp["start"]) * 1e3 for sp in wins],
            "live_tokens_between_windows": between,
            "live_intertoken_ms_p99": float(np.percentile(gaps, 99)),
            "live_intertoken_ms_p50": float(np.median(gaps)),
            "live_intertoken_samples": len(gaps),
            "ttft_ms": long_.ttft_ms}

        # run 3: resume a run-1 stream after its first 16 tokens
        src = prefix_run[2]
        r0 = engine.stats()["resume_admissions"]
        resumed = engine.submit(src.prompt_ids, max_new_tokens=NEW_TOKENS,
                                resume_tokens=src.tokens()[:RESUME_AFTER])
        cont = resumed.tokens(timeout=600)
        if cont != src.tokens()[RESUME_AFTER:] or \
                engine.stats()["resume_admissions"] != r0 + 1:
            raise AssertionError("resume continued with %r, the run said %r"
                                 % (cont, src.tokens()[RESUME_AFTER:]))
        runs["resume"] = {"resume_tokens": RESUME_AFTER,
                          "continuation": len(cont),
                          "cached_prefix_tokens":
                              resumed.cached_prefix_tokens,
                          "admit_windows": resumed.admit_windows,
                          "ttft_ms": resumed.ttft_ms}

        # run 4: 8 batch streams fill the slots; 2 interactive requests
        # preempt two of them
        p0 = engine.stats()["preemptions"]
        batch = [engine.submit(tokens(n), max_new_tokens=BATCH_NEW,
                               priority="batch", tenant="bulk")
                 for n in BATCH_LENS]
        wait_tokens(batch, 4)
        inter = [engine.submit(tokens(n), max_new_tokens=NEW_TOKENS,
                               tenant="live") for n in INTERACTIVE_LENS]
        for s in batch + inter:
            s.tokens(timeout=600)
        victims = [s for s in batch if s.preemptions]
        preempted = engine.stats()["preemptions"] - p0
        if preempted != 2 or len(victims) != 2:
            raise AssertionError("%d preemptions, %d victims"
                                 % (preempted, len(victims)))
        if any(len(s.tokens()) != BATCH_NEW for s in batch):
            raise AssertionError("a batch stream ended short: %r"
                                 % ([len(s.tokens()) for s in batch],))
        admitted = max(s.push_times[0] for s in inter)
        if admitted >= min(s.push_times[-1] for s in victims):
            raise AssertionError("a victim finished before the interactive "
                                 "streams were admitted")
        runs["preemption"] = {
            "preemptions": preempted,
            "victim_prompt_lens": [len(s.prompt_ids) for s in victims],
            "replayed_tokens": engine.stats()["preempt_replayed_tokens"],
            "interactive_ttft_ms": [s.ttft_ms for s in inter]}
        serve_s = time.perf_counter() - t_served
        stats = engine.stats()
    finally:
        engine.stop()
    launches = {"flash_fwd": fa.flash_attention_lse.launches,
                "flash_decode": fa.flash_decode_attention.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    spans = trace.get_spans()
    whole = sum(sp["name"] == "decode_prefill" for sp in spans)
    n_layers = model.cfg.num_layers
    if launches["flash_fwd"] < n_layers * whole:
        raise AssertionError("flash_fwd launched %d times for %d whole-prompt"
                             " prefills" % (launches["flash_fwd"], whole))
    if launches["flash_decode"] < n_layers * stats["steps"]:
        raise AssertionError("flash_decode launched %d times for %d steps"
                             % (launches["flash_decode"], stats["steps"]))
    streams = prefix_run + live + [long_, resumed] + batch + inter
    logit_err, exact_share = teacher_forced_check(model, streams)
    windows = {}
    for sp in spans:
        if sp["name"] == "decode_resume_prefill" and sp["start"] > t_served:
            windows.setdefault(sp["args"]["bucket"], []).append(sp)
    c1 = profiler.get_counters()
    counters = {k: c1.get(k, 0) - c0.get(k, 0) for k in (
        "decode_preemptions", "decode_preempt_replayed_tokens",
        "decode_resume_admissions", "decode_resume_tokens",
        "decode_prefix_hits", "decode_prefix_misses",
        "decode_prefix_evictions", "decode_prefix_cached_tokens",
        "serving_slot_admissions", "serving_slot_retirements")}
    if counters["decode_resume_admissions"] != 1:
        raise AssertionError("decode_resume_admissions moved by %d"
                             % counters["decode_resume_admissions"])
    tokens_out = sum(len(s.tokens()) for s in streams)
    return {
        "phase": "engine_features", "model": "gpt2-small", "slots": 8,
        "max_len": 1024, "prefix_cache_mb": FEATURE_PREFIX_MB,
        "prefix_block": engine.prefix_block,
        "prefix_blocks": FEATURE_BLOCKS, "prefill_chunk": FEATURE_CHUNK,
        "start_s": t_served - t0, "serve_s": serve_s,
        "tokens": tokens_out, "tokens_per_s": tokens_out / serve_s,
        "runs": runs,
        "resume_window_ms_by_bucket": {
            str(b): span_ms(v) for b, v in sorted(windows.items())},
        "whole_prompt_prefills": whole, "counters": counters,
        "peak_mem_mib": peak_mib, "stats": stats, "launches": launches,
        "teacher_forced_max_logit_err": logit_err, "logit_atol": LOGIT_ATOL,
        "exact_argmax_share": exact_share,
    }, launches


def replay_drafter(prompts, runs):
    """A drafter that proposes what an earlier run emitted after the same
    prompt: ``runs`` maps each prompt (a tuple) to its tokens."""
    def fn(history, k):
        for p in prompts:
            if len(history) >= len(p) and history[:len(p)] == p:
                done = len(history) - len(p)
                d = list(runs[tuple(p)][done:done + k])
                return d + [d[-1] if d else 0] * (k - len(d))
        return [0] * k
    return fn


def paged_engine_phase(model):
    """GPT-2 small through the paged engine with speculation: three runs
    of the same 8 prompts on one engine, launch counts zeroed just before
    the engine is built and read after the last run. Run 1 verifies at
    width 4 with the n-gram drafter (prefix misses, blocks published);
    run 2 at width 4 with a drafter replaying run 1's tokens (prefix hits,
    accepted drafts); run 3 at width 1, where every step is the paged
    flash decode kernel."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import decode

    cfg = model.cfg
    prompts = make_prompts(model, PAGED_PROMPT_LENS)
    draft = {"fn": decode._ngram_draft}
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_lse.launches = 0
    fa.flash_decode_attention.launches = 0
    fa.flash_decode_paged_attention.launches = 0
    engine = make_recording_engine()(
        model, slots=8, max_len=PAGED_MAX_LEN, block_size=PAGED_BLOCK,
        spec_tokens=SPEC_K, prefix_cache_mb=PAGED_PREFIX_MB,
        drafter=lambda h, k: draft["fn"](h, k))
    t0 = time.perf_counter()
    engine.start()
    runs, all_streams = [], []
    try:
        start_s = time.perf_counter() - t0
        for name, width in (("width4_ngram", SPEC_K),
                            ("width4_replay", SPEC_K), ("width1", 1)):
            if name == "width4_replay":
                draft["fn"] = replay_drafter(prompts, {
                    tuple(s.prompt_ids): s.tokens() for s in all_streams})
            engine.set_spec_width(width)
            before = dict(engine.stats(),
                          paged_launches=fa.flash_decode_paged_attention.launches)
            streams, seconds, joined_at = drive(engine, prompts, NEW_TOKENS)
            after = engine.stats()
            check_streams(streams, NEW_TOKENS)
            steps = after["steps"] - before["steps"]
            launches = (fa.flash_decode_paged_attention.launches
                        - before["paged_launches"])
            if width == 1 and launches < cfg.num_layers * steps:
                raise AssertionError(
                    "flash_decode_paged launched %d times for %d width-1 "
                    "steps" % (launches, steps))
            step = profiler.summarize_histogram("decode_step_ms")
            drafted = sum(s.spec_drafted for s in streams)
            accepted = sum(s.spec_accepted for s in streams)
            runs.append({
                "run": name, "width": width, "serve_s": seconds,
                "tokens_per_s": NEW_TOKENS * len(streams) / seconds,
                "decode_step_ms_p50": step["p50"],
                "decode_step_ms_mean": step["mean"], "decode_steps": steps,
                "ttft_ms_mean": float(np.mean([s.ttft_ms for s in streams])),
                "spec_drafted": drafted, "spec_accepted": accepted,
                "spec_acceptance": accepted / drafted if drafted else None,
                "cached_prefix_tokens": sum(s.cached_prefix_tokens
                                            for s in streams),
                "prefix_hits": after["prefix_hits"] - before["prefix_hits"],
                "flash_decode_paged_launches": launches,
                "joined_after_tokens": joined_at,
            })
            all_streams += streams
        stats = engine.stats()
    finally:
        engine.stop()
    launches = {"flash_fwd": fa.flash_attention_lse.launches,
                "flash_decode": fa.flash_decode_attention.launches,
                "flash_decode_paged": fa.flash_decode_paged_attention.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if launches["flash_decode_paged"] < 1:
        raise AssertionError("the paged kernel never launched")
    if stats["oom_sheds"]:
        raise AssertionError("%d requests shed for a full pool"
                             % stats["oom_sheds"])
    if runs[1]["cached_prefix_tokens"] <= 0 or runs[1]["spec_accepted"] <= 0:
        raise AssertionError("run 2 had no prefix hit or no accepted draft: "
                             "%r" % (runs[1],))
    logit_err, exact_share = teacher_forced_check(model, all_streams)
    return {
        "phase": "paged_engine", "model": "gpt2-small", "slots": 8,
        "max_len": PAGED_MAX_LEN, "block_size": PAGED_BLOCK,
        "spec_tokens": SPEC_K, "prefix_cache_mb": PAGED_PREFIX_MB,
        "pool_blocks": stats["paged"]["blocks"],
        "prompt_lens": list(PAGED_PROMPT_LENS), "new_tokens": NEW_TOKENS,
        "start_s": start_s, "runs": runs, "peak_mem_mib": peak_mib,
        "stats": stats, "launches": launches,
        "teacher_forced_max_logit_err": logit_err, "logit_atol": LOGIT_ATOL,
        "exact_argmax_share": exact_share,
    }, launches


# ---------------------------------------------------------------------------
# phase 8: the train step
# ---------------------------------------------------------------------------


def train_feed(vocab, seed, counting=False):
    """[8, 1024, 1] feeds: random ids with two padded rows, or (counting)
    a learnable stream, token t+1 = token t + 1 (mod vocab) from a random
    start per row, no padding."""
    rng = np.random.default_rng(seed)
    B, T = TRAIN_BATCH, TRAIN_T
    mask = np.ones((B, T, 1), np.float32)
    if counting:
        ids = (rng.integers(0, vocab, (B, 1)) + np.arange(T)) % vocab
    else:
        ids = rng.integers(0, vocab, (B, T))
        mask[1, 700:] = 0.0
        mask[5, 1000:] = 0.0
    return {"ids": ids.reshape(B, T, 1).astype("int64"),
            "pos_ids": np.tile(np.arange(T).reshape(1, T, 1), (B, 1, 1)),
            "input_mask": mask}


def flash_launches():
    from paddle_tpu_torch.kernels import flash_attention as fa

    return {"flash_fwd": fa.flash_attention_lse.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def zero_flash_launches():
    from paddle_tpu_torch.kernels import flash_attention as fa

    fa.flash_attention_lse.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def step1_grads(model, feed, use_flash):
    """Every parameter's gradient of the step-1 loss (no update)."""
    from paddle_tpu_torch.models import gpt

    dev = model.device
    ids, pos, mask = (torch.as_tensor(feed[n], device=dev)
                      for n in ("ids", "pos_ids", "input_mask"))
    loss = gpt.gpt_lm_loss(model(ids, pos, mask, use_flash=use_flash), ids,
                           mask)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def train_phase(dev):
    """GPT-2 small's train step at batch 8 x 1024, full width and depth,
    fp32, weights from ``init_fluid_params(cfg, 0)``."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.models import gpt

    n_layers = gpt.GPTConfig().num_layers
    # dropout 0: the kernels' gradients against the dense path's
    cfg0 = gpt.GPTConfig(use_flash_attention=True, hidden_dropout=0.0,
                         attention_dropout=0.0)
    model, _opt, _names, _step = gpt.build_gpt_lm_train_eager(
        cfg0, TRAIN_T, learning_rate=TRAIN_LR, device=dev, seed=0)
    feed = train_feed(cfg0.vocab_size, seed=2)
    zero_flash_launches()
    loss_flash, g_flash = step1_grads(model, feed, None)
    launches_bwd = flash_launches()
    if any(n != n_layers for n in launches_bwd.values()):
        raise AssertionError("one backward launched %r, expected %d each"
                             % (launches_bwd, n_layers))
    loss_dense, g_dense = step1_grads(model, feed, False)
    total = float(torch.stack([g.norm() for g in g_dense.values()]).norm())
    floor = GRAD_NORM_FLOOR * total
    rel = {n: float((g_flash[n] - g_dense[n]).norm()
                    / max(float(g_dense[n].norm()), floor)) for n in g_dense}
    worst = max(rel, key=rel.get)
    floored = sorted(n for n in g_dense if float(g_dense[n].norm()) < floor)
    worst_own = max((n for n in rel if n not in floored), key=rel.get)
    if rel[worst] > GRAD_REL_TOL or not np.isfinite(rel[worst]):
        raise AssertionError("step-1 gradient of %s: kernels vs dense path "
                             "relative norm %.3g > %g"
                             % (worst, rel[worst], GRAD_REL_TOL))
    grad_check = {"loss_kernels": loss_flash, "loss_dense": loss_dense,
                  "max_rel_norm": rel[worst], "worst_param": worst,
                  "median_rel_norm": float(np.median(list(rel.values()))),
                  "max_rel_norm_unfloored": rel[worst_own],
                  "worst_unfloored_param": worst_own,
                  "params": len(rel), "tolerance": GRAD_REL_TOL,
                  "grad_norm": total, "floored": floored}
    del model, _opt, _step, g_flash, g_dense
    torch.cuda.empty_cache()

    # dropout 0.1 (GPT-2's recipe): 20 Adam steps, launches read around
    # exactly these steps
    cfg = gpt.GPTConfig(use_flash_attention=True)
    model, _opt, _names, step = gpt.build_gpt_lm_train_eager(
        cfg, TRAIN_T, learning_rate=TRAIN_LR, device=dev, seed=0)
    feed = train_feed(cfg.vocab_size, seed=3, counting=True)
    profiler.reset_histograms()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    t0 = time.perf_counter()
    losses = [step(feed) for _ in range(TRAIN_STEPS)]
    seconds = time.perf_counter() - t0
    launches = flash_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite train loss: %r" % (losses,))
    if not np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1:
        raise AssertionError("train loss did not fall: %r" % (losses,))
    for name, n in launches.items():
        if n != n_layers * TRAIN_STEPS:
            raise AssertionError("%s launched %d times in %d steps, expected "
                                 "%d a step" % (name, n, TRAIN_STEPS,
                                                n_layers))
    step_ms = profiler.summarize_histogram("train_step_ms")
    prof = _profile(lambda: step(feed), reps=1)
    tokens = TRAIN_BATCH * TRAIN_T
    return {
        "phase": "train", "model": "gpt2-small", "batch": TRAIN_BATCH,
        "seq_len": TRAIN_T, "dropout": [cfg.hidden_dropout,
                                        cfg.attention_dropout],
        "learning_rate": TRAIN_LR, "steps": TRAIN_STEPS,
        "grad_check_dropout0": grad_check, "losses": losses,
        "seconds": seconds, "step_ms_p50": step_ms["p50"],
        "step_ms_mean": step_ms["mean"], "step_ms_max": step_ms["max"],
        "tokens_per_s_p50": tokens / (step_ms["p50"] / 1e3),
        "peak_mem_mib": peak_mib, "launches": launches,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
        "profile_step": prof,
    }, launches


# ---------------------------------------------------------------------------
# phase 9: the train step as a Fluid Program
# ---------------------------------------------------------------------------


def build_program(cfg, use_amp=False):
    """GPT-2 small's train program, startup run on the card, weights
    ``init_fluid_params(cfg, 0)`` copied into the scope (the eager
    builder's default). Returns (main, loss, executor, scope)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    with fluid.unique_name.guard():
        main, startup, _feeds, loss = gpt.build_gpt_lm_train(
            cfg, TRAIN_T, learning_rate=TRAIN_LR, use_amp=use_amp)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gpt.load_fluid_scope(scope, gpt.init_fluid_params(cfg, 0))
    return main, loss, exe, scope


def grad_fetching_step(exe, main, loss, feed, scope):
    """(step() -> loss, grads): the first call also fetches the step-1
    gradients of ``AMP_GRAD_PARAMS`` into ``grads`` (numpy, fp32)."""
    grads = {}

    def step():
        names = [] if grads else [n + "@GRAD" for n in AMP_GRAD_PARAMS]
        out = exe.run(main, feed=feed, fetch_list=[loss] + names, scope=scope)
        grads.update(zip(AMP_GRAD_PARAMS, out[1:]))
        return float(out[0].reshape(-1)[0])

    return step, grads


def timed_steps(step, n):
    """(losses, per-step wall ms): each step ends in its loss read (a
    host sync), so the host clock covers its device work."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(step())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def program_train_phase(dev):
    """The program step against the eager step at dropout 0 (10 steps
    from the same weights and feed), each profiled; then 20 program
    steps at dropout 0.1. Launch counts zeroed just before the dropout
    run, read just after."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import gpt

    n_layers = gpt.GPTConfig().num_layers
    cfg0 = gpt.GPTConfig(use_flash_attention=True, hidden_dropout=0.0,
                         attention_dropout=0.0)
    feed = train_feed(cfg0.vocab_size, seed=3, counting=True)
    t0 = time.perf_counter()
    main, loss, exe, scope = build_program(cfg0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_ops = len(main.global_block().ops)
    torch.cuda.reset_peak_memory_stats()
    replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
    prog_step, grads = grad_fetching_step(exe, main, loss, feed, scope)
    zero_flash_launches()
    prog_losses, prog_ms = timed_steps(prog_step, PROGRAM_STEPS)
    prog_launches = flash_launches()
    prog_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
    for name, n in prog_launches.items():
        if n != n_layers * PROGRAM_STEPS:
            raise AssertionError("program: %s launched %d times in %d steps"
                                 % (name, n, PROGRAM_STEPS))
    if replays:
        raise AssertionError("program step replayed %d forwards" % replays)
    prog_prof = _profile(prog_step, reps=1)
    del main, loss, exe, scope, prog_step     # the step holds the scope
    torch.cuda.empty_cache()

    model, _opt, _names, step = gpt.build_gpt_lm_train_eager(
        cfg0, TRAIN_T, learning_rate=TRAIN_LR, device=dev, seed=0)
    torch.cuda.reset_peak_memory_stats()
    eager_losses, eager_ms = timed_steps(lambda: step(feed), PROGRAM_STEPS)
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    eager_prof = _profile(lambda: step(feed), reps=1)
    del model, _opt, step
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(prog_losses, eager_losses)]
    if max(rel) > PROGRAM_LOSS_RTOL or not all(np.isfinite(prog_losses)):
        raise AssertionError("program losses %r vs eager %r"
                             % (prog_losses, eager_losses))
    # The program runs as many GEMMs as the eager step, counted exactly
    # where the step asks for them: the aten ops, each one cuBLAS kernel.
    # The device trace's GEMM kernels are printed beside them, not
    # compared: a trace can fall short of the step by a few records, more
    # often the longer the process has run, a GEMM among them now and
    # then, and two traces of one run lose different kernels. A trace
    # never holds more GEMM kernels than the step ran GEMM ops
    ops = [sum(p["gemm_op_calls"].values()) for p in (prog_prof,
                                                      eager_prof)]
    gemms = [p["launches_by_class"]["gemm"] for p in (prog_prof,
                                                      eager_prof)]
    if ops[0] != ops[1] or not ops[0] or gemms[0] > ops[0] \
            or gemms[1] > ops[1]:
        calls = [p["gemm_kernel_calls"] for p in (prog_prof, eager_prof)]
        raise AssertionError(
            "program step ran %d GEMM ops and %d GEMM kernels, eager %d and "
            "%d; ops %r vs %r; by kernel where they differ (program, "
            "eager): %r" % (ops[0], gemms[0], ops[1], gemms[1],
                            prog_prof["gemm_op_calls"],
                            eager_prof["gemm_op_calls"], {
                                k: (calls[0].get(k, 0), calls[1].get(k, 0))
                                for k in set(calls[0]) | set(calls[1])
                                if calls[0].get(k, 0) != calls[1].get(k, 0)}))
    if prog_prof["launches_by_class"]["flash"] != 3 * n_layers:
        raise AssertionError("profiled program step launched %r flash "
                             "kernels" % prog_prof["launches_by_class"])

    # dropout 0.1 (GPT-2's recipe): the program's main path
    cfg = gpt.GPTConfig(use_flash_attention=True)
    main, loss, exe, scope = build_program(cfg)
    zero_flash_launches()
    drop_losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0].reshape(-1)[0])
                   for _ in range(TRAIN_STEPS)]
    launches = flash_launches()
    del main, loss, exe, scope
    torch.cuda.empty_cache()
    if not all(np.isfinite(drop_losses)):
        raise AssertionError("non-finite program loss: %r" % (drop_losses,))
    if not np.mean(drop_losses[-5:]) < np.mean(drop_losses[:5]) - 0.1:
        raise AssertionError("program loss did not fall: %r" % (drop_losses,))
    for name, n in launches.items():
        if n != n_layers * TRAIN_STEPS:
            raise AssertionError("program: %s launched %d times in %d steps"
                                 % (name, n, TRAIN_STEPS))
    tokens = TRAIN_BATCH * TRAIN_T
    return {
        "phase": "program_train", "model": "gpt2-small",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
        "learning_rate": TRAIN_LR, "program_ops": n_ops,
        "build_and_startup_s": build_s,
        "dropout0": {
            "steps": PROGRAM_STEPS, "program_losses": prog_losses,
            "eager_losses": eager_losses, "max_rel_diff": max(rel),
            "rtol": PROGRAM_LOSS_RTOL,
            "program_step_ms": prog_ms, "eager_step_ms": eager_ms,
            "program_step_ms_p50": float(np.median(prog_ms)),
            "eager_step_ms_p50": float(np.median(eager_ms)),
            "program_tokens_per_s_p50": tokens / (np.median(prog_ms) / 1e3),
            "program_peak_mem_mib": prog_peak, "eager_peak_mem_mib": eager_peak,
            "generic_grad_replays": replays,
            "program_launches": prog_launches,
            "program_profile_step": prog_prof,
            "eager_profile_step": eager_prof},
        "dropout01": {"steps": TRAIN_STEPS, "losses": drop_losses,
                      "dropout": [cfg.hidden_dropout, cfg.attention_dropout]},
    }, launches, grads


# ---------------------------------------------------------------------------
# phase 11: the AMP train step (bf16)
# ---------------------------------------------------------------------------


def amp_train_phase(dev, fp32_step1_loss, fp32_grads):
    """GPT-2 small's AMP train step, ``build_gpt_lm_train(use_amp=True)``
    through ``fluid.Executor(CUDAPlace(0))``, from the fp32 program
    phase's weights and feed: at dropout 0, 10 steps (the step-1 loss
    within ``AMP_LOSS_RTOL`` and the step-1 gradients of
    ``AMP_GRAD_PARAMS`` within ``AMP_GRAD_RTOL`` relative norm of the
    fp32 program's, each bf16 flash kernel 12 launches a step, no generic
    replay), a profiled step (idle, launches by class, the GEMM and flash
    kernels by name), beside the eager AMP step
    (``build_gpt_lm_train_eager(use_amp=True)``, its step-1 loss within
    ``AMP_EAGER_RTOL`` of the program's); then 20 program steps at
    dropout 0.1 that must learn. Launch counts zeroed just before each
    run, read just after; returns them by run."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import gpt

    n_layers = gpt.GPTConfig().num_layers
    cfg0 = gpt.GPTConfig(use_flash_attention=True, hidden_dropout=0.0,
                         attention_dropout=0.0)
    feed = train_feed(cfg0.vocab_size, seed=3, counting=True)
    main, loss, exe, scope = build_program(cfg0, use_amp=True)
    n_ops = len(main.global_block().ops)
    casts = sum(op.type == "cast" for op in main.global_block().ops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
    prog_step, grads = grad_fetching_step(exe, main, loss, feed, scope)
    zero_flash_launches()
    prog_losses, prog_ms = timed_steps(prog_step, PROGRAM_STEPS)
    prog_launches = flash_launches()
    prog_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
    for name, n in prog_launches.items():
        if n != n_layers * PROGRAM_STEPS:
            raise AssertionError("amp program: %s launched %d times in %d "
                                 "steps" % (name, n, PROGRAM_STEPS))
    grad_rel = {n: float(np.linalg.norm(grads[n] - fp32_grads[n])
                         / np.linalg.norm(fp32_grads[n]))
                for n in AMP_GRAD_PARAMS}
    if not max(grad_rel.values()) <= AMP_GRAD_RTOL:
        raise AssertionError("amp step-1 gradients vs fp32: %r" % grad_rel)
    if replays:
        raise AssertionError("amp program step replayed %d forwards"
                             % replays)
    rel = abs(prog_losses[0] - fp32_step1_loss) / abs(fp32_step1_loss)
    if rel > AMP_LOSS_RTOL or not all(np.isfinite(prog_losses)):
        raise AssertionError("amp step-1 loss %r vs fp32 %r (rel %.3g)"
                             % (prog_losses[0], fp32_step1_loss, rel))
    if not prog_losses[-1] < prog_losses[0]:
        raise AssertionError("amp program loss did not fall: %r"
                             % (prog_losses,))
    prog_prof = _profile(prog_step, reps=1)
    if not prog_prof["flash_kernels"] or not all(
            "bfloat16" in k for k in prog_prof["flash_kernels"]):
        raise AssertionError("amp step ran flash kernels %r"
                             % (prog_prof["flash_kernels"],))
    del main, loss, exe, scope, prog_step     # the step holds the scope
    torch.cuda.empty_cache()

    model, _opt, _names, step = gpt.build_gpt_lm_train_eager(
        cfg0, TRAIN_T, learning_rate=TRAIN_LR, use_amp=True, device=dev,
        seed=0)
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    eager_losses, eager_ms = timed_steps(lambda: step(feed), PROGRAM_STEPS)
    eager_launches = flash_launches()
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    eager_prof = _profile(lambda: step(feed), reps=1)
    del model, _opt, step
    torch.cuda.empty_cache()
    eager_rel = abs(eager_losses[0] - prog_losses[0]) / abs(prog_losses[0])
    if eager_rel > AMP_EAGER_RTOL or any(
            n != n_layers * PROGRAM_STEPS for n in eager_launches.values()):
        raise AssertionError("eager amp step: losses %r vs program %r, "
                             "launches %r" % (eager_losses, prog_losses,
                                              eager_launches))
    if not eager_prof["flash_kernels"] or not all(
            "bfloat16" in k for k in eager_prof["flash_kernels"]):
        raise AssertionError("eager amp step ran flash kernels %r"
                             % (eager_prof["flash_kernels"],))

    # dropout 0.1 (GPT-2's recipe): the AMP program's main path
    cfg = gpt.GPTConfig(use_flash_attention=True)
    main, loss, exe, scope = build_program(cfg, use_amp=True)
    zero_flash_launches()
    drop_losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0].reshape(-1)[0])
                   for _ in range(TRAIN_STEPS)]
    launches = flash_launches()
    del main, loss, exe, scope
    torch.cuda.empty_cache()
    if not all(np.isfinite(drop_losses)):
        raise AssertionError("non-finite amp loss: %r" % (drop_losses,))
    if not np.mean(drop_losses[-5:]) < np.mean(drop_losses[:5]) - 0.1:
        raise AssertionError("amp loss did not fall: %r" % (drop_losses,))
    for name, n in launches.items():
        if n != n_layers * TRAIN_STEPS:
            raise AssertionError("amp program: %s launched %d times in %d "
                                 "steps" % (name, n, TRAIN_STEPS))
    tokens = TRAIN_BATCH * TRAIN_T
    return {
        "phase": "amp_train", "model": "gpt2-small", "dtype": "bf16",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
        "learning_rate": TRAIN_LR, "program_ops": n_ops,
        "program_cast_ops": casts,
        "dropout0": {
            "steps": PROGRAM_STEPS, "program_losses": prog_losses,
            "eager_losses": eager_losses,
            "fp32_program_step1_loss": fp32_step1_loss,
            "step1_rel_vs_fp32": rel, "rtol": AMP_LOSS_RTOL,
            "step1_grad_rel_vs_fp32": grad_rel, "grad_rtol": AMP_GRAD_RTOL,
            "eager_step1_rel_vs_program": eager_rel,
            "eager_rtol": AMP_EAGER_RTOL,
            "program_step_ms": prog_ms, "eager_step_ms": eager_ms,
            "program_step_ms_p50": float(np.median(prog_ms)),
            "eager_step_ms_p50": float(np.median(eager_ms)),
            "program_tokens_per_s_p50": tokens / (np.median(prog_ms) / 1e3),
            "program_peak_mem_mib": prog_peak, "eager_peak_mem_mib": eager_peak,
            "generic_grad_replays": replays,
            "program_launches": prog_launches,
            "eager_launches": eager_launches,
            "program_profile_step": prog_prof,
            "eager_profile_step": eager_prof,
            "flash_device_ms_per_step": {
                "program": prog_prof["device_ms_by_class"]["flash"],
                "eager": eager_prof["device_ms_by_class"]["flash"],
                "program_by_kernel": prog_prof["flash_ms_by_kernel"],
                "eager_by_kernel": eager_prof["flash_ms_by_kernel"]}},
        "dropout01": {"steps": TRAIN_STEPS, "losses": drop_losses,
                      "dropout": [cfg.hidden_dropout, cfg.attention_dropout],
                      "launches": launches},
    }, {"amp_program": prog_launches, "amp_eager": eager_launches,
        "amp_program_dropout": launches}


# ---------------------------------------------------------------------------
# phase 10: a learnable attention bias through the program
# ---------------------------------------------------------------------------


def bias_phase(dev):
    """``fluid.layers.flash_attention(q, k, v, bias=b)`` with ``b`` a
    ``create_parameter([1, 12, 1024, 1024])`` per-head bias, q/k/v from
    fc over a fed [8, 1024, 768] input, causal, loss = sum(out · w):
    5 Adam steps through the Executor on the card, launch counts zeroed
    just before them and read just after. The step-1 gradients the
    kernels gave (dq, dk, dv of the split heads, dbias) are held against
    the plain backward on the same tensors."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import flash_attention as fa

    B, N, T, D = TRAIN_BATCH, 12, TRAIN_T, 64
    H = N * D
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[T, H], dtype="float32")
        w = fluid.layers.data(name="w", shape=[N, T, D], dtype="float32")
        bias = fluid.layers.create_parameter([1, N, T, T], "float32",
                                             name="attn_bias")

        def heads(name):
            h = fluid.layers.fc(x, size=H, num_flatten_dims=2, name=name)
            h = fluid.layers.reshape(h, shape=[0, 0, N, D])
            return fluid.layers.transpose(h, perm=[0, 2, 1, 3])

        qv, kv, vv = heads("q"), heads("k"), heads("v")
        out = fluid.layers.flash_attention(qv, kv, vv, bias=bias, causal=True)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, w))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(5)
    feed = {"x": rng.standard_normal((B, T, H), dtype=np.float32),
            "w": rng.standard_normal((B, N, T, D), dtype=np.float32)}
    names = [t.name for t in (qv, kv, vv)]
    fetch = [loss.name, out.name] + names + [n + "@GRAD" for n in names] + [
        "attn_bias@GRAD"]
    bias0 = scope.get("attn_bias").clone()
    zero_flash_launches()
    first = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)
    losses = [float(first[0].reshape(-1)[0])]
    losses += [float(exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope)[0].reshape(-1)[0])
               for _ in range(BIAS_STEPS - 1)]
    launches = flash_launches()
    for name, n in launches.items():
        if n != BIAS_STEPS:
            raise AssertionError("bias program: %s launched %d times in %d "
                                 "steps" % (name, n, BIAS_STEPS))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite bias-program loss %r" % (losses,))
    _loss, got_out, q, k, v, dq, dk, dv, dbias = first
    g = torch.as_tensor(feed["w"], device=dev)
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, bias=bias0,
                                                    causal=True)
    ref = fa.flash_attention_bwd_plain(q, k, v, None, None, ref_out, ref_lse,
                                       g, causal=True, bias=bias0)
    torch.cuda.synchronize()
    check_close("bias program out", got_out, ref_out)
    errs = {"out": max_err(got_out, ref_out)}
    for name, a, b in (("dq", dq, ref[0]), ("dk", dk, ref[1]),
                       ("dv", dv, ref[2]),
                       ("dbias", dbias, ref[4].reshape(dbias.shape))):
        check_close("bias program " + name, a, b, BWD_ATOL, BWD_RTOL)
        errs[name] = max_err(a, b)
    del first, ref, ref_out, ref_lse, scope, exe
    torch.cuda.empty_cache()
    return {"phase": "bias", "shape": [B, N, T, D], "bias_shape": [1, N, T, T],
            "causal": True, "steps": BIAS_STEPS, "losses": losses,
            "step1_max_abs_err": errs, "atol": BWD_ATOL, "rtol": BWD_RTOL,
            "launches": launches}, launches


def _gpt_feed(rows, seq, rng, vocab):
    """Predictor feeds [rows, seq, 1]: random ids, positions, and a mask
    whose last row (of several) pads its last quarter."""
    mask = np.ones((rows, seq, 1), np.float32)
    if rows > 1:
        mask[-1, seq - seq // 4:] = 0.0
    return [rng.integers(0, vocab, (rows, seq, 1)).astype(np.int64),
            np.tile(np.arange(seq).reshape(1, seq, 1),
                    (rows, 1, 1)).astype(np.int64), mask]


def _served_loop(server, requests, clients):
    """Closed loop: ``clients`` threads, each sending its share of
    ``requests`` one at a time and waiting for each result. Returns
    ({request index: logits}, seconds)."""
    import threading

    results, errors = {}, []

    def client(share):
        try:
            for j in share:
                results[j] = server.infer(requests[j], timeout=600)[0]
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=client,
                                args=(range(i, len(requests), clients),))
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    seconds = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError("served loop did not finish")
    return results, seconds


def _serve_run(pred, requests, solo, workers, seq_buckets, n_layers,
               profile_burst):
    """One InferenceServer over ``pred`` at 8 rows a batch and 5 ms of
    gather, warmed on every bucket, driven by the closed loop; every
    result held against the same request run alone (``solo``). Returns
    (line, flash_fwd launches of the served loop)."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    ladder = serving.BucketLadder(max_batch=8, seq_buckets=list(seq_buckets))
    server = serving.InferenceServer(pred, max_batch_size=8,
                                     batch_timeout_ms=5,
                                     num_workers=workers, ladder=ladder)
    example = max(requests, key=lambda r: r[0].shape[1])
    t0 = time.perf_counter()
    server.start(warmup_inputs=example)
    warm_s = time.perf_counter() - t0
    built = ("predictor_plan_cache_misses", "executor_plan_builds",
             "kernel_builds")
    try:
        c0 = dict(profiler.get_counters(), kernel_builds=_build.builds)
        fa.flash_attention_lse.launches = 0
        results, seconds = _served_loop(server, requests, SERVE_CLIENTS)
        launches = fa.flash_attention_lse.launches
        c1 = dict(profiler.get_counters(), kernel_builds=_build.builds)
        stats = server.stats().as_dict()
        prof = None
        if profile_burst:
            # device busy vs wall over bursts of 8 concurrent requests
            burst = requests[:SERVE_CLIENTS]
            prof = _profile(lambda: _served_loop(server, burst,
                                                 SERVE_CLIENTS), reps=2)
    finally:
        server.stop()
    after_warmup = {k: c1.get(k, 0) - c0.get(k, 0) for k in built}
    worst = 0.0
    for j, out in results.items():
        if out.shape != solo[j].shape:
            raise AssertionError("request %d came back %s, alone %s"
                                 % (j, out.shape, solo[j].shape))
        worst = max(worst, float(np.abs(out - solo[j]).max()))
    if len(results) != len(requests) or worst > LOGIT_ATOL:
        raise AssertionError("served results off the solo runs by %.3g "
                             "(tolerance %g)" % (worst, LOGIT_ATOL))
    if any(after_warmup.values()):
        raise AssertionError("built after warmup: %s" % after_warmup)
    if stats["bucket_hit_rate"] != 1.0:
        raise AssertionError("bucket hit rate %s" % stats["bucket_hit_rate"])
    if launches != n_layers * stats["batches"]:
        raise AssertionError("flash_fwd launched %d times for %d batches"
                             % (launches, stats["batches"]))
    line = {"workers": workers, "seq_buckets": list(seq_buckets),
            "requests": len(requests), "seconds": seconds,
            "requests_per_s": len(requests) / seconds, "warmup_s": warm_s,
            "max_abs_err_vs_solo": worst, "built_after_warmup": after_warmup,
            "batch_fill_ratio": stats["batch_fill_ratio"],
            "batches": stats["batches"], "pad_rows": stats["pad_rows"],
            "bucket_hit_rate": stats["bucket_hit_rate"],
            "latency_ms": stats["latency_ms"],
            "flash_fwd_launches": launches}
    if prof is not None:
        line["burst_profile"] = {k: prof[k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "device_ms_by_class", "top")}
    return line, launches


def save_gpt2_infer(dirname, cfg, arrays, seq):
    """``build_gpt_infer(cfg, seq)`` with the parameters ``arrays``,
    saved by ``save_inference_model`` into ``dirname`` from the card;
    returns the seconds the save took."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    with fluid.unique_name.guard():
        main, startup, feeds, logits = gpt.build_gpt_infer(cfg, seq)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gpt.load_fluid_scope(scope, arrays)
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(dirname, feeds, [logits], exe,
                                      main_program=main)
    return time.perf_counter() - t0


def served_gpt2(dev):
    """GPT-2 small (fp32, flash attention, random weights from seed 0)
    saved by ``save_inference_model`` and loaded by ``AnalysisPredictor``,
    beside the eager ``GPTLM`` with the same weights: the inference path
    the inference_server and gateway phases serve. Returns a dict (cfg,
    pred, model, save_s, load_s)."""
    import tempfile

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(use_flash_attention=True)
    arrays = gpt.init_fluid_params(cfg, seed=0)
    workdir = tempfile.mkdtemp(prefix="inference_server_")
    try:
        save_s = save_gpt2_infer(workdir, cfg, arrays, 256)
        t0 = time.perf_counter()
        pred = inference.create_paddle_predictor(
            inference.AnalysisConfig(workdir))
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    model = gpt.GPTLM(cfg, device=dev)
    gpt.load_fluid_params(model, arrays)
    return {"cfg": cfg, "pred": pred, "model": model, "save_s": save_s,
            "load_s": load_s}


def inference_server_phase(dev, served):
    """``served_gpt2``'s predictor served by ``InferenceServer``: the
    predictor against the eager forward; the closed loop through the
    server against the same requests run alone (``SERVE_CLIENTS``
    clients, prompts of 20-256 tokens over the seq buckets 64/128/256,
    two workers; then the same requests through one worker and one seq
    bucket, the reference probe's conditions, where the batch fill must
    reach 0.5); generation through a ``DecodeEngine`` built the
    reference's way over the predictor's own parameters."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt

    torch.cuda.reset_peak_memory_stats()
    cfg, pred, model = served["cfg"], served["pred"], served["model"]
    n_layers = cfg.num_layers
    save_s, load_s = served["save_s"], served["load_s"]

    # 1. the predictor against the eager forward, 12 flash launches a run
    rng = np.random.default_rng(5)
    checks, check_launches = [], 0
    for rows, seq in INFER_CHECKS:
        feed = _gpt_feed(rows, seq, rng, cfg.vocab_size)
        fa.flash_attention_lse.launches = 0
        (got,) = pred.run(feed)
        n = fa.flash_attention_lse.launches
        check_launches += n
        with torch.inference_mode():
            want = model(*(torch.from_numpy(a).to(dev) for a in feed),
                         use_flash=False)
        err = float(np.abs(got - want.float().cpu().numpy()).max())
        checks.append({"rows": rows, "seq": seq, "max_abs_err": err,
                       "flash_fwd_launches": n})
        if n != n_layers or err > LOGIT_ATOL or not np.isfinite(got).all():
            raise AssertionError("predictor run %s: flash_fwd %d, error "
                                 "%.3g" % ((rows, seq), n, err))

    # 2. serving, against the same requests run alone (the serial loop)
    lens = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1,
                        SERVE_CLIENTS * SERVE_PER_CLIENT)
    requests = [_gpt_feed(1, int(n), rng, cfg.vocab_size) for n in lens]
    t0 = time.perf_counter()
    solo = [pred.run(r)[0] for r in requests]
    serial_s = time.perf_counter() - t0
    mixed, mixed_launches = _serve_run(pred, requests, solo, 2,
                                       SERVE_SEQ_BUCKETS, n_layers, True)
    probe, probe_launches = _serve_run(pred, requests, solo, 1,
                                       SERVE_SEQ_BUCKETS[-1:], n_layers,
                                       False)
    del solo
    if probe["batch_fill_ratio"] < 0.5:
        raise AssertionError("batch fill %.3f < 0.5 with one worker and "
                             "one signature" % probe["batch_fill_ratio"])
    serial_rps = len(requests) / serial_s
    big = torch.empty(8, 256, cfg.vocab_size, device=dev)
    big.cpu()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        big.cpu()
    d2h_ms = (time.perf_counter() - t0) * 1e3 / 3
    d2h_bytes = big.numel() * big.element_size()
    del big

    # 3. generation through an engine over the predictor's parameters
    mem0 = torch.cuda.memory_allocated()
    engine = make_recording_engine()(cfg, scope=pred.scope,
                                     param_program=pred.program,
                                     slots=8, max_len=1024)
    engine_added = torch.cuda.memory_allocated() - mem0
    held = {pred.scope.get(n).data_ptr()
            for n in gpt.fluid_param_shapes(cfg)}
    shared = {p.data_ptr() for p in engine.model.parameters()}
    param_bytes = sum(p.numel() * p.element_size()
                      for p in engine.model.parameters())
    if shared != held or engine_added > 2 ** 20:
        raise AssertionError("the engine copied parameters: %d of %d "
                             "tensors shared, %d bytes added"
                             % (len(shared & held), len(held), engine_added))
    gen_server = serving.InferenceServer(pred, decode_engine=engine).start()
    try:
        before = engine.stats()
        fa.flash_attention_lse.launches = 0
        fa.flash_decode_attention.launches = 0
        prompts = make_prompts(model, GEN_LENS, seed=3)
        t0 = time.perf_counter()
        streams = [gen_server.generate(p, max_new_tokens=GEN_NEW)
                   for p in prompts]
        for st in streams:
            st.tokens(timeout=600)
        gen_s = time.perf_counter() - t0
        gen_launches = {"flash_fwd": fa.flash_attention_lse.launches,
                        "flash_decode": fa.flash_decode_attention.launches}
        after = engine.stats()
    finally:
        gen_server.stop()
    prefills = after["prefills"] - before["prefills"]
    steps = after["steps"] - before["steps"]
    if gen_launches["flash_fwd"] < n_layers * prefills or \
            gen_launches["flash_decode"] < n_layers * steps or not steps:
        raise AssertionError("generation launches %s for %d prefills, %d "
                             "steps" % (gen_launches, prefills, steps))
    check_streams(streams, GEN_NEW)
    logit_err, exact_share = teacher_forced_check(model, streams)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {"flash_fwd": check_launches + mixed_launches + probe_launches
                + gen_launches["flash_fwd"],
                "flash_decode": gen_launches["flash_decode"]}
    line = {
        "phase": "inference_server", "model": "gpt2-small",
        "save_s": save_s, "load_s": load_s, "predictor_checks": checks,
        "logit_atol": LOGIT_ATOL,
        "serial": {"requests": len(requests), "seconds": serial_s,
                   "requests_per_s": serial_rps},
        "served_mixed": dict(mixed,
                             speedup=mixed["requests_per_s"] / serial_rps),
        "served_one_signature": dict(
            probe, speedup=probe["requests_per_s"] / serial_rps),
        "logits_d2h": {"bytes": d2h_bytes, "ms": d2h_ms,
                       "gb_per_s": d2h_bytes / d2h_ms / 1e6},
        "generate": {"streams": len(streams), "new_tokens": GEN_NEW,
                     "prompt_lens": list(GEN_LENS), "seconds": gen_s,
                     "prefills": prefills, "steps": steps,
                     "launches": gen_launches,
                     "teacher_forced_max_logit_err": logit_err,
                     "exact_argmax_share": exact_share,
                     "engine_added_bytes": engine_added,
                     "param_bytes": param_bytes},
        "peak_mem_mib": peak_mib, "launches": launches,
    }
    del engine, streams
    torch.cuda.empty_cache()
    return line, launches


def _device_busy(fn):
    """(wall ms, device-busy ms) of one call of ``fn`` under
    torch.profiler: kernel and copy time on the card, whatever thread
    launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            busy_us += e.self_cuda_time_total if us is None else us
    return out, wall_ms, busy_us / 1e3


def gateway_phase(dev, served):
    """The gateway trials (``_gateway_trials``), with the flags, the
    exporter and the preemption latch put back however they end."""
    from paddle_tpu_torch.checkpoint import preempt
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.observability import exporter

    flags.set_flags({"FLAGS_serving_strict_compiles": True,
                     "FLAGS_obs_http_port": 0})
    try:
        return _gateway_trials(served)
    finally:
        exporter.stop_global()
        preempt._reset_for_tests()
        flags.set_flags({"FLAGS_serving_strict_compiles": False,
                         "FLAGS_obs_http_port": -1})


def _gateway_trials(served):
    """``served_gpt2``'s model on HTTP through ``serving.Gateway`` (the
    port's ``paddle_tpu_torch/serving/gateway.py``), with
    ``FLAGS_serving_strict_compiles`` on and the exporter on port 0:
    /v1/generate streams through a ``DecodeEngine(slots=8,
    max_len=1024)`` over the predictor's scope, /v1/infer through the
    classifier's and GPT-2's ``InferenceServer``. Launch counts are zeroed
    just before the storm and read just after it."""
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.observability import exporter, registry, trace
    from paddle_tpu_torch.serving.gateway import decode_tensor, encode_tensor
    from paddle_tpu_torch.tools import gateway_probe as probe

    cfg, pred, model = served["cfg"], served["pred"], served["model"]
    n_layers = cfg.num_layers
    tmp = tempfile.mkdtemp(prefix="gateway_phase_")
    made = []
    recording = make_recording_engine()

    class Tracked(recording.stream_class):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    class Engine(recording):
        stream_class = Tracked

    xd = probe.build_classifier(os.path.join(tmp, "classifier"), "cuda")
    cls_pred = probe.load_predictor(os.path.join(tmp, "classifier"), "cuda")
    engine = Engine(cfg, scope=pred.scope, param_program=pred.program,
                    slots=8, max_len=1024)
    gen_server = serving.InferenceServer(
        cls_pred, max_batch_size=8, batch_timeout_ms=5.0, num_workers=1,
        decode_engine=engine).start(warmup_inputs=[xd])
    rng = np.random.default_rng(9)
    rows = [_gpt_feed(1, GW_INFER_SEQ, rng, cfg.vocab_size)
            for _ in range(GW_INFER_RUNS)]
    gpt_server = serving.InferenceServer(
        pred, max_batch_size=1, batch_timeout_ms=1.0, num_workers=1,
        ladder=serving.BucketLadder(max_batch=1,
                                    seq_buckets=[GW_INFER_SEQ]),
    ).start(warmup_inputs=rows[0])
    logs = {k: os.path.join(tmp, k + ".jsonl") for k in ("gen", "gpt")}
    gw = serving.Gateway(gen_server, port=0, access_log=logs["gen"]).start()
    gw_gpt = serving.Gateway(gpt_server, port=0,
                             access_log=logs["gpt"]).start()
    base = "http://127.0.0.1:%d" % gw.port
    base_gpt = "http://127.0.0.1:%d" % gw_gpt.port
    sent = {"gen": 0, "gpt": 0}
    prompts = make_prompts(model, GW_GEN_LENS, seed=4)
    try:
        # -- in process first: the oracles and the rates to compare -----
        buckets = sorted({r for r, _ in gen_server.ladder.shapes()})
        oracles = probe.bucket_oracles(cls_pred, xd, buckets)
        want_logits = [gpt_server.infer(r)[0] for r in rows]
        t0 = time.perf_counter()
        inproc = [gen_server.generate(p, max_new_tokens=GW_GEN_NEW)
                  for p in prompts]
        want_tokens = [st.tokens(timeout=600) for st in inproc]
        inproc_tps = len(prompts) * GW_GEN_NEW / (time.perf_counter() - t0)
        built = ("predictor_plan_cache_misses", "executor_plan_builds",
                 "serving_steady_recompiles")
        c0 = dict(profiler.get_counters(), kernel_builds=_build.builds)

        # -- the storm: 4 SSE generations + 4 classifier clients, then
        # 2 GPT-2 /v1/infer one at a time --------------------------------
        trace.reset()
        trace_id = trace.new_trace_id()
        results, errors, matched, ttfts = [], [], [], {}

        def gen_client(i):
            try:
                t1 = time.perf_counter()
                hdrs = {"X-Tenant-Id": "gen"}
                if i == 0:
                    hdrs["traceparent"] = trace.format_traceparent(
                        trace_id, "a1b2c3d4e5f60718")
                toks, done = probe._sse(
                    base + "/v1/generate",
                    {"prompt_ids": prompts[i], "max_new_tokens": GW_GEN_NEW},
                    headers=hdrs, timeout=600,
                    on_token=lambda t: ttfts.setdefault(
                        i, (time.perf_counter() - t1) * 1e3))
                results.append((i, toks, done))
            except Exception as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)

        def cls_client():
            try:
                for _ in range(GW_CLASSIFIER_REQS):
                    st, body, _h = probe._post(
                        base + "/v1/infer",
                        {"inputs": [encode_tensor(xd)],
                         "deadline_ms": 60000},
                        headers={"X-Tenant-Id": "cls"})
                    if st != 200:
                        raise AssertionError("classifier %d %r" % (st, body))
                    got = [decode_tensor(t) for t in body["outputs"]]
                    b = probe.matching_bucket(got, oracles)
                    if b is None:
                        raise AssertionError("classifier result matches no "
                                             "bucket's bits")
                    matched.append(b)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        def streams(classifiers):
            """The SSE generations (beside ``classifiers`` classifier
            clients); returns their wall seconds."""
            threads = [threading.Thread(target=gen_client, args=(i,))
                       for i in range(len(prompts))]
            threads += [threading.Thread(target=cls_client)
                        for _ in range(classifiers)]
            t1 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            sent["gen"] += len(prompts) + classifiers * GW_CLASSIFIER_REQS
            if errors:
                raise errors[0]
            return time.perf_counter() - t1

        def storm():
            gen_s = streams(GW_CLASSIFIER_CLIENTS)
            got, ms = [], []
            for r in rows:
                t1 = time.perf_counter()
                st, body, _h = probe._post(
                    base_gpt + "/v1/infer",
                    {"inputs": [encode_tensor(a) for a in r]}, timeout=600)
                if st != 200:
                    raise AssertionError("GPT-2 /v1/infer %d %r"
                                         % (st, body))
                got.append(decode_tensor(body["outputs"][0]))
                ms.append((time.perf_counter() - t1) * 1e3)
            sent["gpt"] += len(rows)
            return gen_s, got, ms

        # SSE alone, against the in-process rate above
        sse_alone_s = streams(0)
        ttft_alone = [ttfts[i] for i in sorted(ttfts)]
        ttfts.clear()
        fa.flash_attention_lse.launches = 0
        fa.flash_decode_attention.launches = 0
        fa.flash_decode_paged_attention.launches = 0
        before = engine.stats()
        t1 = time.perf_counter()
        gen_s, http_logits, gpt_http_ms = storm()
        storm_ms = (time.perf_counter() - t1) * 1e3
        launches = {"flash_fwd": fa.flash_attention_lse.launches,
                    "flash_decode": fa.flash_decode_attention.launches}
        after = engine.stats()
        c1 = dict(profiler.get_counters(), kernel_builds=_build.builds)
        ttft_storm = [ttfts[i] for i in sorted(ttfts)]
        # the client-sent traceparent: its gateway_request span, the
        # ticks that decoded it, and /trace filtered by its id
        exp = exporter.global_exporter()
        with urllib.request.urlopen(
                exp.url("/trace") + "?trace_id=" + trace_id,
                timeout=30) as r:
            traced = json.loads(r.read())
        traced_names = {e["name"] for e in traced["traceEvents"]
                        if e.get("ph") != "M"}
        spans = trace.get_spans()
        gw_span = [sp for sp in spans if sp["name"] == "gateway_request"
                   and sp["trace_id"] == trace_id]
        ticks = [sp for sp in spans if sp["name"] == "decode_tick"
                 and trace_id in sp["args"].get("trace_ids", ())]
        if not gw_span or not ticks or not {
                "gateway_request", "decode_tick"} <= traced_names:
            raise AssertionError("trace id %s: %d gateway spans, %d ticks, "
                                 "/trace %s" % (trace_id, len(gw_span),
                                                len(ticks),
                                                sorted(traced_names)))
        # the same storm again under torch.profiler for the card's busy
        # time; the profiler slows the host, so the idle share divides
        # by the unprofiled storm's wall
        (_s, again, _ms), profiled_ms, busy_ms = _device_busy(storm)
        http_logits += again
        t1 = time.perf_counter()
        for r in rows:
            gpt_server.infer(r)
        gpt_inproc_ms = (time.perf_counter() - t1) * 1e3 / len(rows)
        prefills = after["prefills"] - before["prefills"]
        steps = after["steps"] - before["steps"]
        built_after = {k: c1.get(k, 0) - c0.get(k, 0)
                       for k in built + ("kernel_builds",)}
        if any(built_after.values()):
            raise AssertionError("built under the strict gate: %s"
                                 % built_after)
        if launches["flash_fwd"] < n_layers * (prefills + len(rows)) or \
                launches["flash_decode"] < n_layers * steps or not steps:
            raise AssertionError("storm launches %s for %d prefills, %d "
                                 "infer runs, %d steps"
                                 % (launches, prefills, len(rows), steps))
        mismatch = {}
        if len(results) != 3 * len(prompts):
            raise AssertionError("%d of %d streams came back"
                                 % (len(results), 3 * len(prompts)))
        for i, toks, done in results:
            if len(toks) != GW_GEN_NEW or not done or not done.get("done"):
                raise AssertionError("stream %d ended early: %d tokens, %r"
                                     % (i, len(toks), done))
            if toks != want_tokens[i]:
                first = next(j for j, (a, b) in enumerate(
                    zip(toks, want_tokens[i])) if a != b)
                mismatch.setdefault(i, []).append(first)
        for i, m in mismatch.items():
            print("gateway: stream %d differs from in-process from tokens %s"
                  " (near-ties; teacher-forced below)" % (i, m), flush=True)
        logit_err, exact_share = teacher_forced_check(model, made)
        gpt_bits = [bool(np.array_equal(g.view(np.uint32),
                                        w.view(np.uint32)))
                    for g, w in zip(http_logits, want_logits * 2)]
        if not all(gpt_bits) or http_logits[0].shape != \
                (1, GW_INFER_SEQ, cfg.vocab_size):
            raise AssertionError("GPT-2 /v1/infer logits are not the "
                                 "in-process bits: %s" % gpt_bits)
        if len(matched) != 2 * GW_CLASSIFIER_CLIENTS * GW_CLASSIFIER_REQS:
            raise AssertionError("classifier results: %d" % len(matched))

        # -- the hop against in process, one request at a time ---------
        inproc_ms, http_ms = [], []
        trace.reset()
        for _ in range(20):
            t1 = time.perf_counter()
            gen_server.infer([xd], deadline_ms=60000)
            inproc_ms.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            st, _b, _h = probe._post(base + "/v1/infer",
                                     {"inputs": [encode_tensor(xd)]})
            http_ms.append((time.perf_counter() - t1) * 1e3)
        sent["gen"] += 20
        span_p50 = float(np.median([
            (sp["end"] - sp["start"]) * 1e3 for sp in trace.get_spans()
            if sp["name"] == "gateway_request"]))
        ttft_inproc, ttft_http = [], []
        for _ in range(3):
            t1 = time.perf_counter()
            st_ = gen_server.generate(prompts[0], max_new_tokens=4)
            next(iter(st_.stream_tokens(timeout=60)))
            ttft_inproc.append((time.perf_counter() - t1) * 1e3)
            st_.tokens(timeout=60)
            t1 = time.perf_counter()
            first = []
            probe._sse(base + "/v1/generate",
                       {"prompt_ids": prompts[0], "max_new_tokens": 4},
                       on_token=lambda t: first.append(
                           (time.perf_counter() - t1) * 1e3))
            ttft_http.append(first[0])
        sent["gen"] += 3

        # -- surfaces: 429, 504, /metrics, the trace, the access logs ---
        limited = serving.Gateway(gen_server, port=0, rate_limit_rps=1.0,
                                  rate_burst=1).start()
        try:
            lim = "http://127.0.0.1:%d/v1/infer" % limited.port
            shed0 = (profiler.get_counter("gateway_shed_admission"),
                     profiler.get_counter("gateway_shed_dispatch"))
            r1 = probe._post(lim, {"inputs": [encode_tensor(xd)]},
                             headers={"X-Tenant-Id": "bursty"})
            r2 = probe._post(lim, {"inputs": [encode_tensor(xd)]},
                             headers={"X-Tenant-Id": "bursty"})
        finally:
            limited.stop()
        r3 = probe._post(base + "/v1/infer",
                         {"inputs": [encode_tensor(xd)],
                          "deadline_ms": 0.001})
        sent["gen"] += 1
        shed1 = (profiler.get_counter("gateway_shed_admission"),
                 profiler.get_counter("gateway_shed_dispatch"))
        if not (r1[0] == 200 and r2[0] == 429
                and r2[1].get("reason") == "ratelimit"
                and int(r2[2].get("Retry-After", 0)) >= 1):
            raise AssertionError("429 mapping: %r %r" % (r1[0], r2[:2]))
        if r3[0] != 504 or r3[1].get("reason") != "deadline":
            raise AssertionError("504 mapping: %r" % (r3[:2],))
        if shed1[0] - shed0[0] != 1 or shed1[1] - shed0[1] != 1:
            raise AssertionError("sheds not counted apart: %s -> %s"
                                 % (shed0, shed1))
        with urllib.request.urlopen(exp.url("/metrics"), timeout=30) as r:
            scraped = registry.parse_prometheus(r.read().decode("utf-8"))
        names = {k[0] for k in scraped}
        families = {f: sorted(n for n in names if n.startswith(f))
                    for f in ("gateway_", "decode_")}
        need = ("gateway_requests", "gateway_stream_tokens",
                "gateway_shed_admission", "gateway_shed_dispatch",
                "gateway_latency_ms_count", "gateway_ttft_ms_count",
                "decode_requests", "decode_tokens", "decode_ttft_ms_count",
                "decode_queue_depth")
        missing = [n for n in need if n not in names]
        if missing:
            raise AssertionError("/metrics lacks %s" % missing)
        access = {}
        for k, path in logs.items():
            with open(path) as f:
                access[k] = [json.loads(ln) for ln in f if ln.strip()]
            ids = [ln["request_id"] for ln in access[k]]
            if len(ids) != sent[k] or len(set(ids)) != len(ids):
                raise AssertionError("access log %s: %d lines, %d unique, "
                                     "%d sent" % (k, len(ids), len(set(ids)),
                                                  sent[k]))
    finally:
        gw.stop()
        gw_gpt.stop()
        gen_server.stop()
        gpt_server.stop()

    # -- the paged trial: the same front over the speculative engine ----
    paged = Engine(cfg, scope=pred.scope, param_program=pred.program,
                   slots=4, max_len=PAGED_MAX_LEN, block_size=PAGED_BLOCK,
                   spec_tokens=SPEC_K)
    paged_server = serving.InferenceServer(cls_pred,
                                           decode_engine=paged).start()
    gw_paged = serving.Gateway(paged_server, port=0).start()
    base_paged = "http://127.0.0.1:%d" % gw_paged.port
    paged_prompts = make_prompts(model, GW_PAGED_LENS, seed=5)
    first_paged = len(made)
    try:
        paged_runs = {}
        for width in (SPEC_K, 1):
            paged.set_spec_width(width)
            b0 = paged.stats()
            fa.flash_decode_paged_attention.launches = 0
            outs, errs = {}, []

            def paged_client(i):
                try:
                    outs[i] = probe._sse(
                        base_paged + "/v1/generate",
                        {"prompt_ids": paged_prompts[i],
                         "max_new_tokens": GW_GEN_NEW}, timeout=600)
                except Exception as exc:  # noqa: BLE001
                    errs.append(exc)

            threads = [threading.Thread(target=paged_client, args=(i,))
                       for i in range(len(paged_prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            if errs:
                raise errs[0]
            pl = fa.flash_decode_paged_attention.launches
            psteps = paged.stats()["steps"] - b0["steps"]
            dones = [outs[i][1] for i in sorted(outs)]
            if any(len(outs[i][0]) != GW_GEN_NEW for i in outs):
                raise AssertionError("paged stream ended early")
            facts = [{k: d.get(k) for k in ("spec_drafted", "spec_accepted",
                                            "spec_acceptance")}
                     for d in dones]
            if width > 1 and not all(f["spec_drafted"] for f in facts):
                raise AssertionError("width-%d done events lack the draft "
                                     "facts: %r" % (width, facts))
            if width == 1 and (pl < n_layers * psteps or not psteps):
                raise AssertionError("flash_decode_paged launched %d times "
                                     "for %d width-1 steps" % (pl, psteps))
            paged_runs["width%d" % width] = {
                "steps": psteps, "flash_decode_paged_launches": pl,
                "done_facts": facts}
    finally:
        gw_paged.stop()
        paged_server.stop()
    paged_err, _paged_exact = teacher_forced_check(model, made[first_paged:])
    paged_launches = paged_runs["width1"]["flash_decode_paged_launches"]

    # -- the SIGTERM drain, in a child process ---------------------------
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.gateway_probe",
         "--gpt2", "--drain-only"], cwd=here, env=env, capture_output=True,
        text=True, timeout=600)
    child_s = time.perf_counter() - t0
    lines = [ln for ln in child.stdout.splitlines()
             if ln.startswith("REPORT ")]
    if child.returncode != 0 or not lines:
        raise AssertionError("drain child exit %d: %s %s"
                             % (child.returncode, child.stdout[-1500:],
                                child.stderr[-1500:]))
    drain = json.loads(lines[-1][len("REPORT "):])["drain"]
    shutil.rmtree(tmp, ignore_errors=True)
    launches["flash_decode_paged"] = paged_launches
    tokens = len(prompts) * GW_GEN_NEW
    line = {
        "phase": "gateway", "model": "gpt2-small", "strict_gate": True,
        "storm": {
            "sse_streams": len(prompts), "prompt_lens": list(GW_GEN_LENS),
            "new_tokens": GW_GEN_NEW,
            "classifier_requests": len(matched),
            "classifier_matched_bucket": {str(b): matched.count(b)
                                          for b in sorted(set(matched))},
            "gpt2_infer_runs": len(rows), "gpt2_infer_bit_equal": gpt_bits,
            "prefills": prefills, "steps": steps, "launches": launches,
            "built_after_warmup": built_after,
            "sse_equal_in_process": not mismatch,
            "sse_first_differing_token": mismatch,
            "teacher_forced_max_logit_err": logit_err,
            "exact_argmax_share": exact_share, "logit_atol": LOGIT_ATOL,
            "wall_ms": storm_ms, "sse_section_s": gen_s,
            "device_busy_ms": busy_ms, "profiled_wall_ms": profiled_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / storm_ms),
            "gpt2_infer_http_ms": gpt_http_ms,
            "gpt2_infer_inproc_ms": gpt_inproc_ms,
        },
        "hop": {
            "infer_inproc_p50_ms": float(np.percentile(inproc_ms, 50)),
            "infer_inproc_p99_ms": float(np.percentile(inproc_ms, 99)),
            "infer_http_p50_ms": float(np.percentile(http_ms, 50)),
            "infer_http_p99_ms": float(np.percentile(http_ms, 99)),
            "ttft_inproc_ms": float(np.median(ttft_inproc)),
            "ttft_http_ms": float(np.median(ttft_http)),
            "ttft_sse_alone_ms": ttft_alone,
            "ttft_storm_ms": ttft_storm,
            # engine-stamped (submit to first token) beside the clients'
            "ttft_engine_inproc_ms": [st.ttft_ms for st in inproc],
            "ttft_engine_sse_alone_ms": [d["ttft_ms"] for _i, _t, d
                                         in results[:len(prompts)]],
            "ttft_engine_storm_ms": [d["ttft_ms"] for _i, _t, d
                                     in results[len(prompts):
                                                2 * len(prompts)]],
            "tokens_per_s_inproc": inproc_tps,
            "tokens_per_s_sse_alone": tokens / sse_alone_s,
            "tokens_per_s_sse_storm": tokens / gen_s,
            "gateway_request_span_p50_ms": span_p50,
        },
        "surfaces": {"status_429": [r1[0], r2[0]],
                     "retry_after_s": r2[2].get("Retry-After"),
                     "status_504": r3[0], "trace_id_ticks": len(ticks),
                     "metrics_families": {k: len(v)
                                          for k, v in families.items()},
                     "access_log_lines": {k: len(v)
                                          for k, v in access.items()}},
        "paged": dict(paged_runs, teacher_forced_max_logit_err=paged_err),
        "drain": dict(drain, child_s=child_s),
    }
    return line, launches


# ---------------------------------------------------------------------------
# fleet: the serving control plane
# ---------------------------------------------------------------------------


def fleet_replica_main(argv):
    """The hidden ``--fleet-replica STATS_DIR <replica arguments>`` mode:
    the port's replica process (``serving.replica.main``) and, once its
    drain returns, this process's kernel launches, kernel-library builds,
    peak device memory, device and profiler counters written to
    ``STATS_DIR/replica_<id>.json``. The fleet phase's controller spawns
    its replicas through this mode."""
    from paddle_tpu_torch.checkpoint import modeldir
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import replica

    stats_dir, args = argv[0], argv[1:]
    rc = replica.main(args)
    cuda = torch.cuda.is_available()
    modeldir.commit_json(
        os.path.join(stats_dir, "replica_%s.json"
                     % args[args.index("--replica-id") + 1]),
        {"rc": rc, "device": args[args.index("--device") + 1],
         "cuda": cuda,
         "launches": {"flash_fwd": fa.flash_attention_lse.launches,
                      "flash_decode": fa.flash_decode_attention.launches,
                      "flash_decode_paged":
                          fa.flash_decode_paged_attention.launches},
         "kernel_builds": _build.builds,
         "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
         "counters": profiler.get_counters()})
    return rc


def _fleet_probe_on_card():
    """The port's closed-loop fleet probe with its replicas on the card.
    As in the CPU test, a miss of its timing bars alone (failures
    prefixed "throughput") earns one rerun; any other miss raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    first = None
    for attempt in (1, 2):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_probe",
             "--fast", "--device", "cuda"],
            cwd=root, capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        report = None
        for ln in p.stdout.splitlines():
            if ln.startswith("REPORT "):
                report = json.loads(ln[len("REPORT "):])
        fails = (report or {}).get("failures") or []
        if p.returncode == 0 and "PROBE PASS" in p.stdout:
            break
        if attempt == 2 or not fails or not all(
                f.startswith("throughput") for f in fails):
            raise AssertionError(
                "fleet probe on the card failed (rc %d): %s\n%s\n%s"
                % (p.returncode, fails, p.stdout[-3000:], p.stderr[-3000:]))
        first = fails
    keep = ("boot", "overhead", "failover", "autoscale", "scale_down",
            "rollout", "strict", "generate_failover", "kv_tier",
            "kv_tier_churn", "controller_crash")
    return dict({k: report.get(k) for k in keep}, seconds=secs,
                attempts=attempt, first_attempt_failures=first,
                device=report.get("device"))


def _smi_sampler():
    """nvidia-smi's utilization.gpu of card 0 every 200 ms, in a child
    process: the share of each sample period in which a kernel ran, from
    whichever process."""
    return subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _smi_idle(proc):
    """(idle share, samples) of a ``_smi_sampler`` run; stops it."""
    proc.terminate()
    try:
        out = proc.communicate(timeout=30)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
    vals = [float(x) for x in out.split()
            if re.fullmatch(r"\d+(\.\d+)?", x)]
    if not vals:
        return None, 0
    return 1.0 - float(np.mean(vals)) / 100.0, len(vals)


def _teacher_forced(model, prompt, tokens, alt=None):
    """``tokens`` streamed after ``prompt``, held to the plain full
    forward (dense attention) on the card: each must be the forward's
    argmax or within LOGIT_ATOL of it. With ``alt`` (another run's tokens
    for the same prompt), their first difference must be such a near
    tie too. Returns (exact-argmax count, first difference or None)."""
    dev = model.device
    P = len(prompt)
    seq = list(prompt) + list(tokens[:-1])
    with torch.inference_mode():
        ref = model(torch.tensor([seq], device=dev),
                    torch.arange(len(seq), device=dev)[None],
                    torch.ones(1, len(seq), device=dev),
                    use_flash=False)[0, P - 1:].float()
        toks = torch.tensor(tokens, device=dev)
        top = ref.max(-1).values
        gap = (top - ref[torch.arange(len(tokens), device=dev), toks])
        gap = gap.cpu().numpy()
        argmax = ref.argmax(-1).cpu().numpy()
        diff = None
        if alt is not None:
            diff = next((i for i, (a, b) in enumerate(zip(tokens, alt))
                         if a != b), None)
            if diff is not None:
                d = float((ref[diff, tokens[diff]]
                           - ref[diff, alt[diff]]).abs())
                if d > LOGIT_ATOL:
                    raise AssertionError(
                        "stream differs from the uninterrupted run at "
                        "step %d by %.3g of logit (> %g): not a near tie"
                        % (diff, d, LOGIT_ATOL))
    if not np.isfinite(gap).all() or float(gap.max()) > LOGIT_ATOL:
        raise AssertionError("a streamed token is %.3g of logit below the "
                             "reference argmax (tolerance %g)"
                             % (float(gap.max()), LOGIT_ATOL))
    return int((argmax == np.asarray(tokens)).sum()), diff


def _fleet_gpt2(dev):
    """GPT-2 small served by a FleetController of 3 paged replicas (1
    prefill role, 2 decode) on the card, all traffic through its Router:
    a shared 512-token prefix pulled from the prefill peer, spill and
    readmit on one decode replica, a mid-stream replica death resumed on
    a survivor, and a rollout under /v1/infer traffic. Returns (line,
    launches summed over the replicas that drained)."""
    import tempfile
    import threading
    import urllib.request

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.checkpoint import modeldir
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.serving.gateway import decode_tensor, encode_tensor
    from paddle_tpu_torch.serving.kv_tier import decode_entries
    from paddle_tpu_torch.serving.replica import build_gpt_decode_engine
    from paddle_tpu_torch.tools import gateway_probe as probe
    from paddle_tpu_torch.tools.fleet_probe import _sse_collect

    here = os.path.abspath(__file__)
    work = tempfile.mkdtemp(prefix="fleet_phase_")
    stats_dir = os.path.join(work, "stats")
    os.makedirs(stats_dir)

    class Harness(fleet_mod.FleetController):
        """The controller, spawning its replicas through this script's
        ``--fleet-replica`` mode with the arguments it would give
        ``python -m paddle_tpu_torch.serving.replica``."""

        def _cmd(self, rid, version, model_dir, endpoint_file,
                 role="mixed"):
            argv = super()._cmd(rid, version, model_dir, endpoint_file,
                                role=role)
            assert argv[1:3] == ["-m", "paddle_tpu_torch.serving.replica"]
            return [argv[0], here, "--fleet-replica", stats_dir] + argv[3:]

    out = {}
    cfg = gpt.GPTConfig(
        max_position_embeddings=FLEET_SPEC["max_len"],
        **{k: FLEET_SPEC[k] for k in (
            "vocab_size", "hidden_size", "num_layers", "num_heads",
            "intermediate_size", "use_flash_attention")})
    rng = np.random.default_rng(21)
    row = _gpt_feed(1, FLEET_INFER_SEQ, rng, cfg.vocab_size)
    oracles = {}
    for version, seed in ((1, 0), (2, 1)):
        d = os.path.join(work, "export_v%d" % version)
        save_gpt2_infer(d, cfg, gpt.init_fluid_params(cfg, seed), 256)
        np.savez(os.path.join(d, "warmup.npz"), *row)
        pred = inference.create_paddle_predictor(inference.AnalysisConfig(d))
        oracles[version] = [np.asarray(o) for o in pred.run(row)]
        del pred
    repo = os.path.join(work, "repo")
    modeldir.publish(os.path.join(work, "export_v1"), repo)

    # the in-process model the replicas' seeded engines equal (the same
    # spec, so the same bits), the uninterrupted runs, and the tier's
    # copies timed in process
    oracle_eng = build_gpt_decode_engine(FLEET_SPEC, device="cuda")
    model = oracle_eng.model
    vocab = cfg.vocab_size
    prefixes = [rng.integers(0, vocab, FLEET_PREFIX).tolist()
                for _ in range(3)]
    shared = [prefixes[0] + rng.integers(0, vocab, n - FLEET_PREFIX)
              .tolist() for n in FLEET_SHARED_LENS]
    spill_prompts = [p + rng.integers(0, vocab, 9).tolist()
                     for p in prefixes[1:]]
    failover_prompts = [rng.integers(0, vocab, n).tolist()
                        for n in FLEET_FAILOVER_LENS]
    oracle_eng.start()
    try:
        uninterrupted = [oracle_eng.generate(p, max_new_tokens=FLEET_NEW)
                         .tokens(timeout=600) for p in failover_prompts]
    finally:
        oracle_eng.stop()
    out["in_process"] = _fleet_tier_copies(model, prefixes[0])

    health_s = flags.get_flag("router_health_interval_s")
    flags.set_flags({"FLAGS_router_health_interval_s": 0.25})
    ctrl = Harness(model_dir=repo, workdir=os.path.join(work, "fleet"),
                   replicas=3, roles={"prefill": 1, "decode": 2},
                   replica_env=FLEET_ENV, autoscale=False, seed=0,
                   device="cuda", ready_timeout_s=600.0,
                   replica_args=["--gpt-decode", json.dumps(FLEET_SPEC)])
    smi = None
    streams = []   # (prompt, tokens, done, routed backend)
    try:
        t0 = time.perf_counter()
        ctrl.start()
        ctrl.wait_ready(count=3, timeout=600)
        out["boot_s"] = time.perf_counter() - t0
        ready_ms = [e["ready_ms"] for e in fleet_mod.load_events(ctrl.workdir)
                    if e.get("event") == "replica_ready"]
        out["cold_start_ms"] = ready_ms
        info = {str(i["id"]): i for i in ctrl.replica_info()}
        roles = {rid: i["role"] for rid, i in info.items()}
        if roles != {"0": "prefill", "1": "decode", "2": "decode"}:
            raise AssertionError("replica roles %r" % roles)
        router = ctrl.router
        gen_url = router.url("/v1/generate")
        infer_url = router.url("/v1/infer")

        def metrics(rid):
            port = info[rid]["metrics_port"]
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d/metrics" % port, timeout=30) as r:
                parsed = registry.parse_prometheus(r.read().decode())
            return {k[0]: v for k, v in parsed.items() if not k[1]}

        def infer(url, body):
            st, b, h = probe._post(url, body, timeout=600)
            if st != 200:
                raise AssertionError("/v1/infer %d %r" % (st, b))
            ver = int(h.get("X-Model-Version", 0) or 0)
            got = [decode_tensor(t) for t in b["outputs"]]
            if ver not in oracles or len(got) != len(oracles[ver]) or \
                    not all(g.dtype == o.dtype and g.tobytes() == o.tobytes()
                            for g, o in zip(got, oracles[ver])):
                raise AssertionError("/v1/infer answer does not equal the "
                                     "oracle of version %d bit for bit" % ver)
            return ver

        body = {"inputs": [encode_tensor(a) for a in row]}
        # -- the router hop over a direct gateway call (the router's
        # pick among idle equals is replica 1; the prefill replica serves
        # /v1/kv/prefill only and is not among the router's backends) ---
        direct = "http://127.0.0.1:%d/v1/infer" % info["1"]["gateway_port"]
        hop = {"direct": [], "router": []}
        for _ in range(3):
            for key, url in (("direct", direct), ("router", infer_url)):
                t1 = time.perf_counter()
                infer(url, body)
                hop[key].append((time.perf_counter() - t1) * 1e3)
        out["hop_ms"] = {k: {"p50": float(np.percentile(v, 50)),
                             "p99": float(np.percentile(v, 99))}
                         for k, v in hop.items()}
        out["hop_ms"]["p50_added"] = (out["hop_ms"]["router"]["p50"]
                                      - out["hop_ms"]["direct"]["p50"])

        smi = _smi_sampler()
        t_traffic = time.perf_counter()

        def gen(prompt, new=FLEET_NEW):
            st, events, comments, gaps, hdrs = _sse_collect(
                gen_url, {"prompt_ids": prompt, "max_new_tokens": new,
                          "deadline_ms": 600000}, timeout=900)
            toks = [e["token"] for e in events if "token" in e]
            done = next((e for e in events if e.get("done")), None)
            errs = [e for e in events if "error" in e]
            if st != 200 or errs or not done or len(toks) != new:
                raise AssertionError("stream %d: %d tokens, errors %r, "
                                     "done %r" % (st, len(toks), errs, done))
            rec = {"prompt": prompt, "tokens": toks, "done": done,
                   "backend": hdrs.get("X-Routed-Backend"),
                   "comments": comments, "gaps": gaps,
                   "client_ttft_ms": gaps[0] * 1e3}
            streams.append(rec)
            return rec

        # -- 1. a shared 512-token prefix: pulled, then by affinity -----
        first = gen(shared[0])
        decode_rid = first["backend"]
        if decode_rid != "1":
            raise AssertionError("the first shared-prefix request went to "
                                 "replica %r, not decode replica 1"
                                 % decode_rid)
        m1 = metrics(decode_rid)
        pulled = {k: m1.get(k, 0) for k in (
            "kv_tier_pulls", "kv_tier_pull_failures", "kv_tier_pull_tokens")}
        if pulled["kv_tier_pulls"] < 1 or pulled["kv_tier_pull_failures"] \
                or pulled["kv_tier_pull_tokens"] < FLEET_PREFIX \
                or first["done"].get("cached_prefix_tokens", 0) \
                < FLEET_READMIT_MIN:
            raise AssertionError("no chain pull behind the first shared "
                                 "request: %r, done %r"
                                 % (pulled, first["done"]))
        time.sleep(4 * 0.25)  # two health polls: the adverts refresh
        hits0 = registry.counter("router_affinity_hits").value()
        for p in shared[1:]:
            rec = gen(p)
            if rec["backend"] != decode_rid or \
                    rec["done"].get("cached_prefix_tokens", 0) \
                    < FLEET_READMIT_MIN:
                raise AssertionError("a shared-prefix request went to %r "
                                     "with %r cached tokens"
                                     % (rec["backend"], rec["done"].get(
                                         "cached_prefix_tokens")))
        affinity = registry.counter("router_affinity_hits").value() - hits0
        if affinity < len(shared) - 1:
            raise AssertionError("%d of %d shared-prefix requests routed by "
                                 "affinity" % (affinity, len(shared) - 1))
        # the pull's cost for one 512-token chain, straight from the peer
        t1 = time.perf_counter()
        st, chain, _h = probe._post(
            "http://127.0.0.1:%d/v1/kv/prefill" % info["0"]["gateway_port"],
            {"prompt_ids": prefixes[0]}, timeout=600)
        t2 = time.perf_counter()
        row_shape = [cfg.num_heads, 16, cfg.hidden_size // cfg.num_heads]
        entries = decode_entries(chain.get("blocks") or [], row_shape)
        t3 = time.perf_counter()
        if st != 200 or len(entries) != FLEET_PREFIX // 16:
            raise AssertionError("/v1/kv/prefill %d: %d blocks"
                                 % (st, len(entries)))
        out["pull_512"] = {"http_ms": (t2 - t1) * 1e3,
                           "decode_ms": (t3 - t2) * 1e3,
                           "served_ms": chain.get("served_ms"),
                           "blocks": len(entries),
                           "first_request_ttft_ms": {
                               "client": first["client_ttft_ms"],
                               "engine": first["done"].get("ttft_ms")}}

        # -- 2. two more prefixes through replica 1: spill, readmit -----
        before = metrics(decode_rid)
        for p in spill_prompts:
            rec = gen(p)
            if rec["backend"] != decode_rid:
                raise AssertionError("spill prompt went to %r"
                                     % rec["backend"])
        mid = metrics(decode_rid)
        again = gen(shared[0])
        after = metrics(decode_rid)
        spills = mid.get("kv_tier_spills", 0) - before.get("kv_tier_spills", 0)
        readmits = after.get("kv_tier_readmits", 0) \
            - mid.get("kv_tier_readmits", 0)
        repulls = after.get("kv_tier_pulls", 0) - mid.get("kv_tier_pulls", 0)
        cached = again["done"].get("cached_prefix_tokens", 0)
        if again["backend"] != decode_rid or spills < 1 or readmits < 1 \
                or repulls or cached < FLEET_READMIT_MIN:
            raise AssertionError(
                "no readmit from the host: backend %r, spills %d, readmits "
                "%d, pulls %d, cached %d" % (again["backend"], spills,
                                             readmits, repulls, cached))
        out["spill_readmit"] = {"spills": spills, "readmits": readmits,
                                "cached_prefix_tokens": cached,
                                "ttft_ms": {
                                    "client": again["client_ttft_ms"],
                                    "engine": again["done"].get("ttft_ms")}}
        # -- 3. a replica dies mid-stream; its streams resume -----------
        results = [None] * len(failover_prompts)

        def client(i):
            try:
                results[i] = gen(failover_prompts[i])
            except Exception as exc:  # noqa: BLE001 - counted below
                results[i] = exc

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(len(failover_prompts))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(900)
        failed = [r for r in results if not isinstance(r, dict)]
        if failed:
            raise AssertionError("%d failover streams failed: %r"
                                 % (len(failed), failed[:2]))
        resumed = [r for r in results if r["comments"]]
        if not resumed:
            raise AssertionError("no stream failed over")
        blips = [r["gaps"][i] * 1e3 for r in resumed
                 for _c, i in r["comments"] if i < len(r["gaps"])]
        equal = 0
        for r, want in zip(results, uninterrupted):
            _n, diff = _teacher_forced(model, r["prompt"], r["tokens"],
                                       alt=want)
            equal += int(diff is None)
        deadline = time.monotonic() + 120
        while not any(e.get("event") == "replica_crash"
                      for e in fleet_mod.load_events(ctrl.workdir)):
            if time.monotonic() > deadline:
                raise AssertionError("no replica_crash after the chaos kill")
            time.sleep(0.1)
        t1 = time.perf_counter()
        ctrl.wait_ready(count=3, timeout=600)
        out["failover"] = {"streams": len(results),
                           "resumed": len(resumed),
                           "equal_to_uninterrupted": equal,
                           "blip_ms": blips,
                           "replaced_in_s": time.perf_counter() - t1}

        # -- 4. rollout under /v1/infer traffic -------------------------
        info = {str(i["id"]): i for i in ctrl.replica_info()}
        answers, errors = [], []
        stop = threading.Event()

        def infer_client():
            while not stop.is_set():
                try:
                    answers.append(infer(infer_url, body))
                except Exception as exc:  # noqa: BLE001 - counted below
                    errors.append(exc)

        modeldir.publish(os.path.join(work, "export_v2"), repo)
        clients = [threading.Thread(target=infer_client) for _ in range(2)]
        for th in clients:
            th.start()
        t1 = time.perf_counter()
        deployed = ctrl.deploy(repo)
        out_roll_ms = (time.perf_counter() - t1) * 1e3
        post = [infer(infer_url, body) for _ in range(4)]
        stop.set()
        for th in clients:
            th.join(900)
        if errors or deployed != 2 or post != [2] * 4 or not answers:
            raise AssertionError("rollout: deployed %r, %d errors %r, post "
                                 "versions %r" % (deployed, len(errors),
                                                  errors[:2], post))
        out["rollout"] = {"ms": out_roll_ms, "requests": len(answers),
                          "versions": sorted(set(answers)),
                          "failed": len(errors)}
        out["traffic_s"] = time.perf_counter() - t_traffic
        out["idle_share"], out["idle_samples"] = _smi_idle(smi)
        smi = None

        # -- the builds gate on every live replica ----------------------
        info = {str(i["id"]): i for i in ctrl.replica_info()
                if i["state"] == "ready"}
        steady = {rid: metrics(rid).get("serving_steady_recompiles", 0)
                  for rid in info}
        fails = {rid: metrics(rid).get("kv_tier_pull_failures", 0)
                 for rid in info}
        if any(steady.values()) or any(fails.values()):
            raise AssertionError("steady builds %r, pull failures %r"
                                 % (steady, fails))
    finally:
        if smi is not None:
            _smi_idle(smi)
        ctrl.stop()
        flags.set_flags({"FLAGS_router_health_interval_s": health_s})

    # every stream teacher-forced against the in-process model
    exact = total = 0
    for rec in streams:
        n, _d = _teacher_forced(model, rec["prompt"], rec["tokens"])
        exact += n
        total += len(rec["tokens"])
    out["teacher_forced"] = {"streams": len(streams), "tokens": total,
                             "exact_argmax_share": exact / max(total, 1)}

    # each replica's own account, written when it drained
    stats = {}
    for fn in sorted(os.listdir(stats_dir)):
        with open(os.path.join(stats_dir, fn)) as f:
            stats[fn[len("replica_"):-len(".json")]] = json.load(f)
    spawned = sorted(str(e["replica"]) for e in fleet_mod.load_events(
        ctrl.workdir) if e.get("event") == "replica_spawn")
    missing = sorted(set(spawned) - set(stats) - {str(FLEET_DIE_REPLICA)})
    if missing:
        raise AssertionError("replicas %s left no stats" % missing)
    per = {}
    launches = {"flash_fwd": 0, "flash_decode": 0, "flash_decode_paged": 0}
    for rid, st in stats.items():
        c, la = st["counters"], st["launches"]
        steps = c.get("decode_steps", 0)
        batches = c.get("serving_batches", 0)
        if st["device"] != "cuda" or not st["cuda"] or st["rc"] != 0 \
                or st["kernel_builds"]:
            raise AssertionError("replica %s: %r" % (rid, {
                k: st[k] for k in ("device", "cuda", "rc", "kernel_builds")}))
        if la["flash_decode_paged"] < cfg.num_layers * steps or not steps \
                or la["flash_fwd"] < cfg.num_layers * batches:
            raise AssertionError("replica %s launches %r for %d steps, %d "
                                 "infer batches" % (rid, la, steps, batches))
        for k in launches:
            launches[k] += la[k]
        per[rid] = {"launches": la, "steps": steps, "prefills":
                    c.get("decode_prefills", 0), "infer_batches": batches,
                    "peak_gb": st["peak_bytes"] / 2 ** 30,
                    "kv": {k: c.get(k, 0) for k in (
                        "kv_tier_spills", "kv_tier_readmits",
                        "kv_tier_pulls", "kv_tier_pull_tokens",
                        "kv_tier_bytes_d2h", "kv_tier_bytes_h2d")}}
    out["replicas"] = per
    shutil.rmtree(work, ignore_errors=True)
    return out, launches


def _fleet_tier_copies(model, prefix):
    """The KV tier's copies timed in process on a paged engine over the
    fleet's model (block 16, 54 MB index, 256 MB host tier): a cold
    prefill of the 512-token prefix (the local prefill a pull replaces),
    the spill read of its 32 blocks (one gather + one D2H to pageable
    memory), and their readmit write (one pageable H2D + index_copy_)."""
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.serving import DecodeEngine

    flags.set_flags({"FLAGS_kv_tier_host_mb": 256.0})
    try:
        eng = DecodeEngine(model, slots=8, max_len=1024, block_size=16,
                           prefix_cache_mb=54.0).start()
    finally:
        flags.set_flags({"FLAGS_kv_tier_host_mb": 0.0})
    try:
        s = eng.generate(prefix + [7], max_new_tokens=1)
        s.tokens(timeout=600)
        local_ttft = s.ttft_ms
    finally:
        eng.stop()
    blocks = [e.block_idx for e in list(eng.pindex._entries.values())][:32]
    d2h, h2d = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = eng._read_rows(blocks)
        d2h.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        eng._write_rows(blocks, rows)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    nbytes = rows.nbytes
    return {"local_prefill_ttft_ms": local_ttft, "blocks": len(blocks),
            "batch_bytes": nbytes,
            "spill_d2h_ms_per_batch": float(np.median(d2h)),
            "readmit_h2d_ms_per_block": float(np.median(h2d)) / len(blocks),
            "d2h_gb_s": nbytes / (float(np.median(d2h)) * 1e-3) / 1e9,
            "h2d_gb_s": nbytes / (float(np.median(h2d)) * 1e-3) / 1e9}


def fleet_phase(dev):
    """The port's serving control plane on the card: the fleet probe
    (``_fleet_probe_on_card``), then GPT-2 small from a fleet
    (``_fleet_gpt2``). Returns (line, launches of the GPT-2 fleet's
    replicas)."""
    probe = _fleet_probe_on_card()
    gpt2, launches = _fleet_gpt2(dev)
    return dict({"phase": "fleet", "probe": probe}, **gpt2), launches


def programs_phase(dev):
    """The KV-cache serving programs on the card (see PROG_* above).
    Returns (the phase's line, the program calls' kernel launches)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import decode

    t_phase = time.perf_counter()
    cfg = gpt.GPTConfig(use_flash_attention=True)
    n_layers = cfg.num_layers
    scope = fluid.Scope()
    for name, arr in gpt.init_fluid_params(cfg, seed=0).items():
        scope.set(name, torch.from_numpy(arr).to(dev))
    # the eager session's model: its parameters are the scope's tensors
    model = gpt.share_fluid_scope(gpt.GPTLM(cfg, device="meta"), scope)
    place = fluid.CUDAPlace(0)
    kernels = {"flash_fwd": fa.flash_attention_lse,
               "flash_decode": fa.flash_decode_attention,
               "flash_decode_paged": fa.flash_decode_paged_attention}
    launches = dict.fromkeys(kernels, 0)
    worst = {"logits": 0.0, "state": 0.0}
    rng = np.random.RandomState(16)

    def counted(fn, *args, **kw):
        """``fn(...)`` with the launches it made, added to ``launches``."""
        before = {k: w.launches for k, w in kernels.items()}
        out = fn(*args, **kw)
        delta = {k: w.launches - before[k] for k, w in kernels.items()}
        for k, n in delta.items():
            launches[k] += n
        return out, delta

    def both(prog, eager, call, *args, **kw):
        """The program session's call (its launches counted), then the
        eager session's on the same inputs; their logits compared."""
        got, delta = counted(getattr(prog, call), *args, **kw)
        want = getattr(eager, call)(*args, **kw)
        if want is not None:
            err = float(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)).max())
            if not np.isfinite(got).all() or err > PROG_LOGIT_ATOL:
                raise AssertionError("programs: %s logits %.3g from the "
                                     "eager session's (tolerance %g)"
                                     % (call, err, PROG_LOGIT_ATOL))
            worst["logits"] = max(worst["logits"], err)
        return got, delta

    def expect(delta, what, **want):
        got = {k: delta[k] for k in want}
        if got != want:
            raise AssertionError("programs: %s launched %s, expected %s"
                                 % (what, got, want))

    def same_state(prog, eager, what):
        """Every cache row, store block or pool block, program vs eager;
        a paged pool's sink (block 0) takes every idle and pad write, so
        its contents are garbage by contract and left out."""
        first = 1 if prog.paged else 0
        for (pk, pv), (ek, ev) in zip(prog.caches + prog.stores,
                                      eager.caches + eager.stores):
            err = max(max_err(pk[first:], ek[first:]),
                      max_err(pv[first:], ev[first:]))
            if not err <= PROG_STATE_ATOL:
                raise AssertionError("programs: %s state %.3g from the "
                                     "eager session's (tolerance %g)"
                                     % (what, err, PROG_STATE_ATOL))
            worst["state"] = max(worst["state"], err)

    def timed(prog_fn, eager_fn):
        """Host p50 of each form's step over PROG_TIMED_STEPS calls in
        turns, then each profiled (device busy, idle share)."""
        host = {"program": [], "eager": []}
        for _ in range(PROG_TIMED_STEPS):
            for form, fn in (("program", prog_fn), ("eager", eager_fn)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()   # returns host numpy: ends in a sync
                host[form].append((time.perf_counter() - t0) * 1e3)
        out = {}
        for form, fn in (("program", prog_fn), ("eager", eager_fn)):
            prof = _profile(fn, reps=10)
            out[form] = {
                "host_ms_p50": float(np.median(host[form])),
                "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "launches_per_step": prof["launches_per_call"],
                "launches_by_class": prof["launches_by_class"]}
        return out

    def drop(sess):
        scope.erase(list(sess.cache_tensors()))

    # -- the contiguous pool ------------------------------------------------
    kw = dict(slots=8, max_len=1024, build_resume=True,
              prefix_blocks=PROG_PREFIX_BLOCKS,
              prefix_block=PROG_PREFIX_BLOCK, block_size=0, spec_tokens=0)
    csess = decode.DecodeSession(cfg, place=place, scope=scope, **kw)
    ceager = decode.DecodeSession(model, **kw)
    if not isinstance(csess, decode.ProgramDecodeSession):
        raise AssertionError("DecodeSession(cfg, ...) is not the program form")
    t0 = time.perf_counter()
    csess.warmup()
    prog_warmup_s = time.perf_counter() - t0
    ceager.warmup()
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in PAGED_PROMPT_LENS]
    logits = []
    for slot, p in enumerate(prompts):
        got, delta = both(csess, ceager, "prefill", slot, p)
        expect(delta, "a prefill", flash_fwd=n_layers)
        logits.append(got)
    same_state(csess, ceager, "after the prefills")
    # a prefix hit on slot 7: slot 3's first block published and copied
    # into slot 7's row head, the rest of its prompt a resume window
    both(csess, ceager, "prefix_publish", 3, 0, 1)
    both(csess, ceager, "prefix_copy_in", 7, 0, 1)
    hit = prompts[3]
    got, delta = both(csess, ceager, "resume_prefill", 7,
                      hit[PROG_PREFIX_BLOCK:], PROG_PREFIX_BLOCK)
    expect(delta, "a resume window", flash_fwd=0, flash_decode=0)
    hit_err = float(np.abs(got - logits[3]).max())
    if hit_err > LOGIT_ATOL:
        raise AssertionError("programs: the hit's resume window gives "
                             "logits %.3g from its prefill's" % hit_err)
    prompts[7], logits[7] = hit, got
    same_state(csess, ceager, "after the hit")
    toks = [int(np.argmax(lv)) for lv in logits]
    pos = [len(p) for p in prompts]
    for _ in range(PROG_STEPS):
        got, delta = both(csess, ceager, "decode_step", toks, pos,
                          [True] * 8)
        expect(delta, "a decode step", flash_decode=n_layers)
        toks = [int(t) for t in got.argmax(-1)]
        pos = [q + 1 for q in pos]
    same_state(csess, ceager, "after the decode steps")
    step_args = (toks, pos, [True] * 8)
    contiguous_times = timed(lambda: csess.decode_step(*step_args),
                             lambda: ceager.decode_step(*step_args))
    drop(csess)
    del csess, ceager
    torch.cuda.empty_cache()

    # -- the paged pool -----------------------------------------------------
    kw = dict(slots=8, max_len=PAGED_MAX_LEN, block_size=PAGED_BLOCK,
              spec_tokens=SPEC_K)
    psess = decode.DecodeSession(cfg, place=place, scope=scope, **kw)
    peager = decode.DecodeSession(model, **kw)
    psess.warmup()
    peager.warmup()
    mb = psess.max_blocks
    need = [-(-(len(p) + PROG_STEPS + SPEC_K) // PAGED_BLOCK)
            for p in prompts]
    tables = [list(range(1 + s * mb, 1 + s * mb + n))
              for s, n in enumerate(need)]
    windows = 0
    for slot, p in enumerate(prompts):
        for off in range(0, len(p), PROG_WINDOW):
            got, delta = both(psess, peager, "paged_window", tables[slot],
                              p[off:off + PROG_WINDOW], off)
            expect(delta, "a paged window", flash_fwd=0,
                   flash_decode_paged=0)
            windows += 1
        logits[slot] = got
    same_state(psess, peager, "after the paged windows")
    toks = [int(np.argmax(lv)) for lv in logits]
    pos = [len(p) for p in prompts]
    for _ in range(PROG_STEPS):
        got, delta = both(psess, peager, "paged_step",
                          np.array(toks).reshape(8, 1), pos, tables,
                          [True] * 8)
        expect(delta, "a width-1 paged step", flash_decode_paged=n_layers)
        toks = [int(t) for t in got[:, 0].argmax(-1)]
        pos = [q + 1 for q in pos]
    draft = np.array([[t] * SPEC_K for t in toks])
    got, delta = both(psess, peager, "paged_step", draft, pos, tables,
                      [True] * 8, width=SPEC_K)
    expect(delta, "the width-%d verify" % SPEC_K, flash_decode_paged=0)
    # copy-on-write: slot 0's last block into a block no table maps
    both(psess, peager, "block_copy", [tables[0][-1]],
         [1 + need[0]])
    same_state(psess, peager, "after the steps, verify and block copy")
    step_args = (np.array(toks).reshape(8, 1), pos, tables, [True] * 8)
    paged_times = timed(lambda: psess.paged_step(*step_args),
                        lambda: peager.paged_step(*step_args))
    drop(psess)
    del psess, peager
    torch.cuda.empty_cache()

    # -- the reference-form greedy_generate ---------------------------------
    with fluid.unique_name.guard():
        infer, _startup, _feeds, logits_var = gpt.build_gpt_infer(cfg, 1024)
    exe = fluid.Executor(place)
    prompt = rng.randint(0, cfg.vocab_size, PROG_GEN_PROMPT).tolist()
    max_len = PROG_GEN_PROMPT + PROG_GEN_NEW
    t0 = time.perf_counter()
    ids, delta = counted(gpt.greedy_generate, exe, infer, logits_var, cfg,
                         prompt, max_len, scope=scope)
    gen_s = time.perf_counter() - t0
    expect(delta, "greedy_generate", flash_fwd=n_layers,
           flash_decode=n_layers * (PROG_GEN_NEW - 1))
    tokens = ids[PROG_GEN_PROMPT:]
    if ids[:PROG_GEN_PROMPT] != prompt or len(tokens) != PROG_GEN_NEW:
        raise AssertionError("greedy_generate returned %d ids for %d + %d"
                             % (len(ids), PROG_GEN_PROMPT, PROG_GEN_NEW))
    eager_ids = gpt.greedy_generate(model, prompt, max_len)
    exact, diff = _teacher_forced(model, prompt, tokens,
                                  alt=eager_ids[PROG_GEN_PROMPT:])
    return {
        "phase": "programs", "model": "gpt2-small", "dtype": "fp32",
        "logit_atol": PROG_LOGIT_ATOL, "state_atol": PROG_STATE_ATOL,
        "max_logit_err_vs_eager": worst["logits"],
        "max_state_err_vs_eager": worst["state"],
        "hit_vs_prefill_logit_err": hit_err,
        "contiguous": {"slots": 8, "max_len": 1024, "prefills": 8,
                       "prefix_copies": 2, "resume_windows": 1,
                       "steps": PROG_STEPS, "warmup_s": prog_warmup_s,
                       "step_times": contiguous_times},
        "paged": {"slots": 8, "max_len": PAGED_MAX_LEN,
                  "block": PAGED_BLOCK, "pool_blocks": 8 * mb + 1,
                  "windows": windows, "width1_steps": PROG_STEPS,
                  "verify_width": SPEC_K, "block_copies": 1,
                  "step_times": paged_times},
        "greedy_generate": {"prompt": PROG_GEN_PROMPT, "new": PROG_GEN_NEW,
                            "seconds": gen_s, "exact_argmax": exact,
                            "first_diff_vs_eager": diff},
        "launches": launches, "seconds": time.perf_counter() - t_phase,
    }, launches


# ---------------------------------------------------------------------------
# phase 16: BERT-base's classifier through the Executor
# ---------------------------------------------------------------------------


def bert_feed(seq, batch, seed, vocab=30522):
    """The classifier's feeds: random ids, positions, ragged real lengths
    (``bert_lengths``) with the sentence id 1 from halfway through each
    row's real tokens, the padded tail masked, random binary labels."""
    rng = np.random.default_rng(seed)
    lens = bert_lengths(batch, seq, seed)
    mask = np.zeros((batch, seq, 1), np.float32)
    sent = np.zeros((batch, seq, 1), np.int64)
    for i, n in enumerate(lens):
        mask[i, :n] = 1.0
        sent[i, n // 2:] = 1
    return {"src_ids": rng.integers(0, vocab, (batch, seq, 1)),
            "pos_ids": np.tile(np.arange(seq).reshape(1, seq, 1),
                               (batch, 1, 1)),
            "sent_ids": sent, "input_mask": mask,
            "label": rng.integers(0, 2, (batch, 1))}


def program_arrays(main, scope):
    """Every persistable of ``main`` in ``scope``, copied to numpy on the
    host (a copy even from the CPU: the ops update the tensors in place)."""
    return {v.name: scope.get(v.name).detach().to("cpu", copy=True).numpy()
            for v in main.list_vars() if v.persistable}


def bert_program(cfg, seq, use_amp=False, arrays=None, lr=BERT_LR):
    """BERT's classifier program on the card, startup run; ``arrays``
    (every persistable but the AMP program's ``loss_scaling``, which
    keeps its startup value) copied in with ``load_program_scope``.
    Returns (main, loss, acc, executor, scope)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    with fluid.unique_name.guard():
        main, startup, _feeds, loss, acc = bert.build_bert_classifier(
            cfg, seq, learning_rate=lr, use_amp=use_amp)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if arrays is not None:
        if use_amp:
            arrays = dict(arrays, loss_scaling=scope.get(
                "loss_scaling").cpu().numpy())
        fluid.load_program_scope(main, scope, arrays)
    return main, loss, acc, exe, scope


def loss_step(exe, main, loss, feed, scope):
    return lambda: float(exe.run(main, feed=feed, fetch_list=[loss],
                                 scope=scope)[0].reshape(-1)[0])


def rel_norms(got, want, floor_share=0.0):
    """{name: ||got - want|| / max(||want||, floor)}, the floor
    ``floor_share`` of the norm of all of ``want`` together."""
    total = float(np.sqrt(sum(float(np.linalg.norm(w)) ** 2
                              for w in want.values())))
    floor = floor_share * total
    return {n: float(np.linalg.norm(got[n] - w)
                     / max(float(np.linalg.norm(w)), floor, 1e-30))
            for n, w in want.items()}, total


def bert_phase(dev):
    """BERT-base's classifier (``build_bert_classifier(cfg, 384)``) at
    batch 24 through ``fluid.Executor(CUDAPlace(0))``: flash against the
    dense path at dropout 0 (step-1 loss and every gradient; 12 launches
    of each training kernel, no generic replay), 20 Adam steps at dropout
    0.1 that must learn (the main path: launch counts zeroed just before
    them and read just after), one AMP step against the fp32 step (bf16
    kernels only, 12 launches each), then step times: fp32 and AMP, dense
    and flash at seq 128 and 384."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    n_layers = bert.BertConfig.base().num_layers
    drop0 = dict(hidden_dropout=0.0, attention_dropout=0.0)
    feed = bert_feed(BERT_SEQ, BERT_BATCH, seed=4)
    lens = feed["input_mask"].sum((1, 2)).astype(int).tolist()

    # flash against dense, dropout 0, the same weights
    cfg0 = bert.BertConfig.base(use_flash_attention=True, **drop0)
    t0 = time.perf_counter()
    main, loss, _acc, exe, scope = bert_program(cfg0, BERT_SEQ)
    build_s = time.perf_counter() - t0
    n_ops = len(main.global_block().ops)
    arrays = program_arrays(main, scope)
    names = sorted(p.name for p in main.all_parameters())
    grads = {}
    for path, cfg in (("flash", cfg0), ("dense", bert.BertConfig.base(
            use_flash_attention=False, **drop0))):
        if path == "dense":
            main, loss, _acc, exe, scope = bert_program(cfg, BERT_SEQ,
                                                        arrays=arrays)
        replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
        zero_flash_launches()
        out = exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
        launched = flash_launches()
        replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
        want = n_layers if path == "flash" else 0
        if any(n != want for n in launched.values()) or replays:
            raise AssertionError("bert %s step launched %r (expected %d "
                                 "each), %d generic replays"
                                 % (path, launched, want, replays))
        grads[path] = (float(out[0].reshape(-1)[0]), dict(zip(names,
                                                              out[1:])))
        del main, loss, exe, scope, out
        torch.cuda.empty_cache()
    (loss_flash, g_flash), (loss_dense, g_dense) = grads["flash"], \
        grads["dense"]
    del grads
    rel, gnorm = rel_norms(g_flash, g_dense, GRAD_NORM_FLOOR)
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_flash - loss_dense) / abs(loss_dense)
    if not (rel[worst] <= GRAD_REL_TOL and loss_rel <= BERT_LOSS_RTOL):
        raise AssertionError("bert flash vs dense: loss %r vs %r, gradient "
                             "of %s at relative norm %.3g"
                             % (loss_flash, loss_dense, worst, rel[worst]))
    del g_dense

    # the main path: dropout 0.1, 20 Adam steps on one fixed batch
    cfg = bert.BertConfig.base(use_flash_attention=True)
    main, loss, _acc, exe, scope = bert_program(cfg, BERT_SEQ, arrays=arrays)
    step = loss_step(exe, main, loss, feed, scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    losses, ms = timed_steps(step, BERT_STEPS)
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(losses)) or not np.mean(
            losses[-5:]) < np.mean(losses[:5]) - BERT_LEARN_MARGIN:
        raise AssertionError("bert loss did not fall by %g: %r"
                             % (BERT_LEARN_MARGIN, losses))
    for kname, n in launches.items():
        if n != n_layers * BERT_STEPS:
            raise AssertionError("bert: %s launched %d times in %d steps"
                                 % (kname, n, BERT_STEPS))
    prof = _profile(step, reps=1)
    del main, loss, exe, scope, step
    torch.cuda.empty_cache()
    fp32 = {"step_ms": ms, "step_ms_p50": float(np.median(ms)),
            "seq_per_s_p50": BERT_BATCH / (np.median(ms) / 1e3),
            "peak_mem_mib": peak, "profile_step": prof,
            "device_idle_share": prof["device_idle_share"]}

    # AMP: one step against fp32's at dropout 0, then timed at dropout 0.1
    main, loss, _acc, exe, scope = bert_program(cfg0, BERT_SEQ, use_amp=True,
                                                arrays=arrays)
    replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
    zero_flash_launches()
    fetched = BERT_AMP_GRAD_PARAMS + BERT_Q_PARAMS
    out = exe.run(main, feed=feed, fetch_list=[loss] + [
        n + "@GRAD" for n in fetched], scope=scope)
    amp_launches = flash_launches()
    replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
    amp_loss = float(out[0].reshape(-1)[0])
    all_rel, _n = rel_norms(dict(zip(fetched, out[1:])),
                            {n: g_flash[n] for n in fetched})
    amp_rel = {n: all_rel[n] for n in BERT_AMP_GRAD_PARAMS}
    q_rel = [all_rel[n] for n in BERT_Q_PARAMS]
    q_norm = [float(np.linalg.norm(g_flash[n])) for n in BERT_Q_PARAMS]
    amp_loss_rel = abs(amp_loss - loss_flash) / abs(loss_flash)
    del out
    if any(n != n_layers for n in amp_launches.values()) or replays:
        raise AssertionError("bert amp step launched %r, %d generic replays"
                             % (amp_launches, replays))
    if not (amp_loss_rel <= BERT_AMP_LOSS_RTOL
            and max(amp_rel.values()) <= BERT_AMP_GRAD_RTOL):
        raise AssertionError("bert amp step-1 loss %r vs fp32 %r, gradients "
                             "%r" % (amp_loss, loss_flash, amp_rel))
    amp_prof = _profile(loss_step(exe, main, loss, feed, scope), reps=1)
    if not amp_prof["flash_kernels"] or not all(
            "bfloat16" in k for k in amp_prof["flash_kernels"]) or any(
            n != n_layers for n in
            amp_prof["flash_launches_by_kernel"].values()):
        raise AssertionError("bert amp step ran flash kernels %r, %r"
                             % (amp_prof["flash_kernels"],
                                amp_prof["flash_launches_by_kernel"]))
    del main, loss, exe, scope
    torch.cuda.empty_cache()
    # the dense AMP program's Q-projection gradients beside them: the same
    # bf16 products with the softmax backward in place of the kernels'
    # delta from the bf16 O
    dense_amp = bert.BertConfig.base(use_flash_attention=False, **drop0)
    main, loss, _acc, exe, scope = bert_program(dense_amp, BERT_SEQ,
                                                use_amp=True, arrays=arrays)
    out = exe.run(main, feed=feed, fetch_list=[
        n + "@GRAD" for n in BERT_Q_PARAMS], scope=scope)
    dense_rel, _n = rel_norms(dict(zip(BERT_Q_PARAMS, out)),
                              {n: g_flash[n] for n in BERT_Q_PARAMS})
    dense_q_rel = [dense_rel[n] for n in BERT_Q_PARAMS]
    del main, loss, exe, scope, out, g_flash
    torch.cuda.empty_cache()
    main, loss, _acc, exe, scope = bert_program(cfg, BERT_SEQ, use_amp=True,
                                                arrays=arrays)
    torch.cuda.reset_peak_memory_stats()
    amp_losses, amp_ms = timed_steps(loss_step(exe, main, loss, feed, scope),
                                     BERT_TIMED_STEPS)
    amp_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del main, loss, exe, scope
    torch.cuda.empty_cache()
    if not all(np.isfinite(amp_losses)):
        raise AssertionError("bert amp losses %r" % (amp_losses,))
    amp = {"step1_loss": amp_loss, "step1_rel_vs_fp32": amp_loss_rel,
           "rtol": BERT_AMP_LOSS_RTOL, "step1_grad_rel_vs_fp32": amp_rel,
           "grad_rtol": BERT_AMP_GRAD_RTOL,
           "q_proj_grad_rel_by_layer": q_rel,
           "dense_amp_q_proj_grad_rel_by_layer": dense_q_rel,
           "q_proj_fp32_grad_norm_by_layer": q_norm,
           "launches_step1": amp_launches,
           "profile_step_dropout0": amp_prof,
           "device_idle_share": amp_prof["device_idle_share"],
           "dropout01_losses": amp_losses, "step_ms": amp_ms,
           "step_ms_p50": float(np.median(amp_ms[1:])),
           "seq_per_s_p50": BERT_BATCH / (np.median(amp_ms[1:]) / 1e3),
           "peak_mem_mib": amp_peak}

    # the dense/flash crossover at dropout 0.1: step ms (the first step,
    # which builds the plan, left out)
    crossover = {}
    for seq, batch in BERT_CROSSOVER:
        cfeed = bert_feed(seq, batch, seed=5)
        for flash in (False, True):
            if (seq, flash) == (BERT_SEQ, True):
                crossover["seq%d_flash" % seq] = {
                    "batch": batch, "step_ms_p50": fp32["step_ms_p50"],
                    "from": "the learning run"}
                continue
            c = bert.BertConfig.base(use_flash_attention=flash)
            main, loss, _acc, exe, scope = bert_program(c, seq, arrays=arrays)
            closs, cms = timed_steps(loss_step(exe, main, loss, cfeed,
                                               scope), BERT_TIMED_STEPS)
            del main, loss, exe, scope
            torch.cuda.empty_cache()
            if not all(np.isfinite(closs)):
                raise AssertionError("bert seq %d flash=%s losses %r"
                                     % (seq, flash, closs))
            crossover["seq%d_%s" % (seq, "flash" if flash else "dense")] = {
                "batch": batch, "step_ms": cms,
                "step_ms_p50": float(np.median(cms[1:]))}
        crossover["seq%d_dense_over_flash" % seq] = (
            crossover["seq%d_dense" % seq]["step_ms_p50"]
            / crossover["seq%d_flash" % seq]["step_ms_p50"])
    return {
        "phase": "bert", "model": "bert-base", "seq_len": BERT_SEQ,
        "batch": BERT_BATCH, "real_lengths": lens, "program_ops": n_ops,
        "build_and_startup_s": build_s, "learning_rate": BERT_LR,
        "flash_vs_dense_dropout0": {
            "loss_flash": loss_flash, "loss_dense": loss_dense,
            "loss_rel": loss_rel, "loss_rtol": BERT_LOSS_RTOL,
            "max_rel_norm": rel[worst], "worst_param": worst,
            "median_rel_norm": float(np.median(list(rel.values()))),
            "params": len(rel), "tolerance": GRAD_REL_TOL,
            "grad_norm": gnorm},
        "learning": {"steps": BERT_STEPS, "losses": losses,
                     "dropout": [cfg.hidden_dropout, cfg.attention_dropout],
                     "margin": BERT_LEARN_MARGIN, "launches": launches},
        "fp32": fp32, "amp": amp, "crossover": crossover,
        "seconds": time.perf_counter() - t_phase,
    }, {"bert": launches, "bert_amp": amp_launches}


# ---------------------------------------------------------------------------
# phase 18: Transformer NMT and sub-block control flow through the Executor
# ---------------------------------------------------------------------------
def nmt_lengths(batch, seq, seed):
    """Each row's real length, drawn from the seed between
    ``seq / NMT_MIN_SHARE`` and ``seq``."""
    rng = np.random.default_rng(seed)
    return rng.integers(seq // NMT_MIN_SHARE, seq + 1, batch)


def nmt_feed(seed, copy=False, vocab=30000):
    """The train program's feeds at batch 64, source 64, target 48: ragged
    real lengths (``nmt_lengths``), ids 0 and mask 0 past them. Random
    target ids and labels, or (``copy``) the copy task: target = BOS +
    the source, labels = the source, a row's target as long as its
    source (at most 48)."""
    rng = np.random.default_rng(seed)
    B, S, T = NMT_BATCH, NMT_SRC, NMT_TGT
    src_len = nmt_lengths(B, S, seed)
    src = rng.integers(2, vocab, (B, S))
    if copy:
        tgt_len = np.minimum(src_len, T)
        tgt = np.concatenate([np.full((B, 1), NMT_BOS), src[:, :T - 1]], 1)
        lab = src[:, :T]
    else:
        tgt_len = nmt_lengths(B, T, seed + 1)
        tgt, lab = rng.integers(2, vocab, (B, T)), rng.integers(2, vocab,
                                                                 (B, T))
    src_mask = (np.arange(S)[None, :] < src_len[:, None]).astype(np.float32)
    tgt_mask = (np.arange(T)[None, :] < tgt_len[:, None]).astype(np.float32)

    def col(a):
        return a.reshape(a.shape + (1,))

    return {"src_ids": col(src * src_mask.astype(np.int64)),
            "src_pos": col(np.tile(np.arange(S), (B, 1))),
            "src_mask": col(src_mask),
            "tgt_ids": col((tgt * tgt_mask).astype(np.int64)),
            "tgt_pos": col(np.tile(np.arange(T), (B, 1))),
            "tgt_mask": col(tgt_mask),
            "labels": col((lab * tgt_mask).astype(np.int64))}


def _log_softmax(x):
    """``beam_search_decode``'s log-softmax, term for term (in x's type)."""
    m = x.max(-1, keepdims=True)
    return x - np.log(np.exp(x - m).sum(-1, keepdims=True)) - m


class _BeamProbe(object):
    """Stands in for the Executor that ``beam_search_decode`` drives: runs
    the flash inference program as the search asks, timing the run to
    the logits on the card apart from their copy to pageable host memory
    (the search's own ``np.asarray``), then the dense program on the same
    feed. Keeps each step's logits row of both (the position the search
    reads) and the largest difference at the real target positions (the
    padded ones attend differently in the two forms)."""

    def __init__(self, exe, dense, dense_logits):
        self.exe = exe
        self.dense = dense
        self.dense_logits = dense_logits
        self.steps = []

    def run(self, program, feed=None, fetch_list=None, scope=None):
        t = len(self.steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lg,) = self.exe.run(program, feed=feed, fetch_list=fetch_list,
                             scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = lg.detach().cpu().numpy()
        t2 = time.perf_counter()
        (dl,) = self.exe.run(self.dense, feed=feed,
                             fetch_list=[self.dense_logits], scope=scope,
                             return_numpy=False)
        real_err = float((lg[:, :t + 1] - dl[:, :t + 1]).abs().max())
        self.steps.append({"flash": host[:, t].copy(),
                           "dense": dl[:, t].cpu().numpy(),
                           "device_ms": (t1 - t0) * 1e3,
                           "d2h_ms": (t2 - t1) * 1e3,
                           "d2h_bytes": host.nbytes,
                           "real_logit_err": real_err})
        return [host]


def _beams_teacher_forced(steps, N, K, V, eos):
    """Replays ``beam_search_decode``'s choices from the flash logits it
    read and, at every step, holds each chosen extension to the dense
    program's totals on the same beams: its dense total must be at least
    the K-th largest's less 1e-3 (a near-tie may order either way).
    Returns (the replay's sequences and scores, sorted as the search
    sorts them, the worst shortfall)."""
    scores = np.full((N, K), -1e9, np.float64)
    scores[:, 0] = 0.0
    finished = np.zeros((N, K), bool)
    toks = []
    worst = -np.inf
    for st in steps:
        lp = {}
        for name in ("flash", "dense"):
            x = _log_softmax(st[name].reshape(N, K, V))
            lp[name] = np.where(finished[..., None], np.where(
                np.arange(V)[None, None, :] == eos, 0.0, -1e9), x)
        tot_f = (scores[..., None] + lp["flash"]).reshape(N, K * V)
        tot_d = (scores[..., None] + lp["dense"]).reshape(N, K * V)
        top = np.argsort(-tot_f, axis=1)[:, :K]
        kth = np.sort(tot_d, axis=1)[:, -K]
        chosen = np.take_along_axis(tot_d, top, axis=1)
        worst = max(worst, float((kth[:, None] - chosen).max()))
        beam, tok = top // V, top % V
        toks = [np.take_along_axis(c, beam, axis=1) for c in toks] + [tok]
        finished = np.take_along_axis(finished, beam, axis=1) | (tok == eos)
        scores = np.take_along_axis(tot_f, top, axis=1)
    order = np.argsort(-scores, axis=1)
    toks = np.stack(toks, -1)
    return (np.take_along_axis(toks, order[..., None], axis=1),
            np.take_along_axis(scores, order, axis=1), worst)


def _dense_scores(exe, dense, dense_logits, scope, src, seqs, eos):
    """Each returned beam's score recomputed through the dense program
    (one run over the whole sequences, all target positions real):
    log-probabilities of its tokens summed until its first ``eos``
    (a finished beam extends at no cost)."""
    N, K, T = seqs.shape
    S = src.shape[1]
    flat = seqs.reshape(N * K, T)
    feed = {"src_ids": np.repeat(src, K, 0)[..., None],
            "src_pos": np.tile(np.arange(S), (N * K, 1))[..., None],
            "src_mask": np.ones((N * K, S, 1), np.float32),
            "tgt_ids": flat[..., None],
            "tgt_pos": np.tile(np.arange(T), (N * K, 1))[..., None],
            "tgt_mask": np.ones((N * K, T, 1), np.float32)}
    (lg,) = exe.run(dense, feed=feed, fetch_list=[dense_logits], scope=scope)
    lp = _log_softmax(lg.astype(np.float64))          # [N*K, T, V]
    picked = np.take_along_axis(lp[:, :-1], flat[:, 1:, None], 2)[..., 0]
    done = np.cumsum(flat[:, 1:] == eos, 1) > 0
    before = np.concatenate([np.zeros((N * K, 1), bool), done[:, :-1]], 1)
    return np.where(before, 0.0, picked).sum(1).reshape(N, K)


def nmt_control_flow(dev):
    """The ``While`` RNN of ``tests/test_while_cond_grad.py`` at B 64, T
    32, H 512 with a ``cond`` on its mean, ``append_backward``, on the
    card and on the CPU from the same W (each run once before it is
    measured): loss and dloss/dW held, the condition reads a loop
    iteration, each device's run ms."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import executor as texec
    from paddle_tpu_torch.fluid import profiler

    B, T, H = NMT_RNN_B, NMT_RNN_T, NMT_RNN_H
    rng = np.random.default_rng(12)
    xb = rng.standard_normal((B, T, H)).astype(np.float32)
    w0 = (rng.standard_normal((H, H)) * 0.5 / np.sqrt(H)).astype(np.float32)
    out = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[T, H], dtype="float32")
            arr = fluid.layers.lod_tensor_to_array(
                x, fluid.layers.lod_rank_table(x))
            i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
            n = fluid.layers.fill_constant(shape=[1], dtype="int64", value=T)
            mem = fluid.layers.fill_constant(shape=[B, H], dtype="float32",
                                             value=0.0)
            mem.stop_gradient = False
            W = fluid.layers.create_parameter(shape=[H, H], dtype="float32",
                                              name="W")
            cond = fluid.layers.less_than(i, n)
            loop = fluid.layers.While(cond)
            with loop.block():
                xt = fluid.layers.array_read(arr, i)
                fluid.layers.assign(fluid.layers.tanh(
                    fluid.layers.matmul(mem, W) + xt), output=mem)
                fluid.layers.increment(i, value=1, in_place=True)
                fluid.layers.less_than(i, n, cond=cond)
            s = fluid.layers.reduce_mean(mem)
            zero = fluid.layers.fill_constant(shape=[1], dtype="float32",
                                              value=0.0)
            loss = fluid.layers.cond(fluid.layers.greater_than(s, zero),
                                     lambda: s * 2.0, lambda: s * -1.0)
            (_p, g), = fluid.backward.append_backward(loss)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        scope.set("W", torch.from_numpy(w0.copy()).to(exe.device))
        exe.run(main, feed={"x": xb}, fetch_list=[loss, g], scope=scope)
        syncs0 = profiler.get_counter(texec.HOST_SYNC_COUNTER)
        t0 = time.perf_counter()
        got = exe.run(main, feed={"x": xb}, fetch_list=[loss, g],
                      scope=scope)
        ms = (time.perf_counter() - t0) * 1e3
        syncs = profiler.get_counter(texec.HOST_SYNC_COUNTER) - syncs0
        out.append((got, ms, syncs))
    ((lc, gc), card_ms, syncs), ((lp, gp), cpu_ms, _s) = out
    loss_rel = abs(float(lc[0]) - float(lp[0])) / abs(float(lp[0]))
    grad_rel = float(np.linalg.norm(gc - gp) / np.linalg.norm(gp))
    if not (loss_rel <= NMT_RNN_LOSS_RTOL and grad_rel <= NMT_RNN_GRAD_RTOL):
        raise AssertionError("while/cond on the card vs the CPU: loss %r vs "
                             "%r, dW at relative norm %.3g"
                             % (float(lc[0]), float(lp[0]), grad_rel))
    # the loop reads its condition before every iteration and once more
    # at its end; each of cond's two conditional_blocks reads its own
    return {"shape": [B, T, H], "loss": float(lc[0]), "loss_rel": loss_rel,
            "loss_rtol": NMT_RNN_LOSS_RTOL, "grad_rel": grad_rel,
            "grad_rtol": NMT_RNN_GRAD_RTOL, "host_syncs_per_run": syncs,
            "loop_condition_syncs_per_iteration": (syncs - 2) / T,
            "card_run_ms": card_ms, "cpu_run_ms": cpu_ms}


def nmt_phase(dev):
    """Transformer NMT at Transformer-base's widths through
    ``fluid.Executor(CUDAPlace(0))``: flash against dense at step 1, the
    copy task learning (the main path: launch counts zeroed just before
    and read just after), beam search on the trained weights held
    teacher-forced to the dense program, and the sub-block control flow
    against the CPU."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    counter = "@LR_DECAY_COUNTER@"

    def config(flash):
        return tfm.TransformerConfig(use_flash_attention=flash, dropout=0.0,
                                     label_smooth=0.1)

    def program(flash, arrays=None, lr=2.0, warmup=4000):
        with fluid.unique_name.guard():
            main, startup, _f, loss = tfm.build_transformer_train(
                config(flash), NMT_SRC, NMT_TGT, learning_rate=lr,
                warmup_steps=warmup)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if arrays is not None:
            fluid.load_program_scope(main, scope, arrays)
        return main, loss, exe, scope

    cfg = config(True)
    per_step = 3 * cfg.num_layers
    feed = nmt_feed(seed=4)

    # flash against dense at step 1, the same weights
    t0 = time.perf_counter()
    main, loss, exe, scope = program(True)
    build_s = time.perf_counter() - t0
    n_ops = len(main.global_block().ops)
    arrays = program_arrays(main, scope)
    names = sorted(p.name for p in main.all_parameters() if p.trainable)
    grads = {}
    for flash in (True, False):
        if not flash:
            main, loss, exe, scope = program(False, arrays)
        replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
        zero_flash_launches()
        out = exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
        launched = flash_launches()
        replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
        want = per_step if flash else 0
        if any(n != want for n in launched.values()) or replays:
            raise AssertionError("nmt %s step launched %r (expected %d each),"
                                 " %d generic replays" % (
                                     "flash" if flash else "dense", launched,
                                     want, replays))
        grads[flash] = (float(out[0].reshape(-1)[0]),
                        dict(zip(names, out[1:])))
        del main, loss, exe, scope, out
        torch.cuda.empty_cache()
    (loss_flash, g_flash), (loss_dense, g_dense) = grads[True], grads[False]
    del grads
    # the k-projection biases' exact gradient is 0: each side's is
    # rounding noise, held to NMT_ZERO_GRAD_SHARE of the whole gradient
    zero = sorted(n for n in g_dense if "att_k.b_0" in n)
    rel, gnorm = rel_norms({n: g for n, g in g_flash.items()
                            if n not in zero},
                           {n: g for n, g in g_dense.items()
                            if n not in zero}, GRAD_NORM_FLOOR)
    worst = max(rel, key=rel.get)
    zero_norm = max(float(np.linalg.norm(g[n])) for g in (g_flash, g_dense)
                    for n in zero)
    loss_rel = abs(loss_flash - loss_dense) / abs(loss_dense)
    del g_flash, g_dense
    if not (rel[worst] <= GRAD_REL_TOL and loss_rel <= NMT_LOSS_RTOL
            and zero_norm <= NMT_ZERO_GRAD_SHARE * gnorm):
        raise AssertionError("nmt flash vs dense: loss %r vs %r, gradient of "
                             "%s at relative norm %.3g, k-bias gradient "
                             "norm %.3g of %.3g"
                             % (loss_flash, loss_dense, worst, rel[worst],
                                zero_norm, gnorm))

    # the main path: the copy task, Noam-scheduled Adam on one batch
    main, loss, exe, scope = program(True, arrays, lr=NMT_LR,
                                     warmup=NMT_WARMUP)
    copy = nmt_feed(seed=5, copy=True)
    counts = []

    def step():
        lv, c = exe.run(main, feed=copy, fetch_list=[loss, counter],
                        scope=scope)
        counts.append(int(c.reshape(-1)[0]))
        return float(lv.reshape(-1)[0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    losses, ms = timed_steps(step, NMT_STEPS)
    train_launches = flash_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if counts != list(range(1, NMT_STEPS + 1)):
        raise AssertionError("nmt step counter read %r" % (counts,))
    if not all(np.isfinite(losses)) or not np.mean(
            losses[-5:]) < np.mean(losses[:5]) - NMT_LEARN_MARGIN:
        raise AssertionError("nmt loss did not fall by %g: %r"
                             % (NMT_LEARN_MARGIN, losses))
    for kname, n in train_launches.items():
        if n != per_step * NMT_STEPS:
            raise AssertionError("nmt: %s launched %d times in %d steps"
                                 % (kname, n, NMT_STEPS))
    prof = _profile(step, reps=1)
    tokens = float(copy["tgt_mask"].sum())
    p50 = float(np.median(ms[1:]))

    # beam search on the trained weights, flash, held to the dense program
    N, K, L = NMT_BEAM_N, NMT_BEAM_K, NMT_BEAM_LEN
    infer, _feeds, logits = tfm.build_transformer_infer(config(True), L, L)
    dense, _feeds, dense_logits = tfm.build_transformer_infer(config(False),
                                                              L, L)
    src = copy["src_ids"][:N, :L, 0]
    probe = _BeamProbe(exe, dense, dense_logits)
    zero_flash_launches()
    seqs, scores = tfm.beam_search_decode(
        probe, infer, logits, cfg, src, bos_id=NMT_BOS, eos_id=NMT_EOS,
        beam_size=K, max_len=L, scope=scope)
    beam_launches = flash_launches()
    n_steps = len(probe.steps)
    if beam_launches != {"flash_fwd": per_step * n_steps, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0}:
        raise AssertionError("nmt beam search: %d steps launched %r"
                             % (n_steps, beam_launches))
    logit_err = max(st["real_logit_err"] for st in probe.steps)
    replay_seqs, replay_scores, shortfall = _beams_teacher_forced(
        probe.steps, N, K, cfg.tgt_vocab, NMT_EOS)
    dense_scores = _dense_scores(exe, dense, dense_logits, scope, src, seqs,
                                 NMT_EOS)
    score_err = float(np.abs(dense_scores - scores).max())
    if not (logit_err <= LOGIT_ATOL and shortfall <= 1e-3
            and np.array_equal(replay_seqs, seqs[:, :, 1:n_steps + 1])
            and np.allclose(replay_scores, scores, rtol=0, atol=1e-9)
            and score_err <= 1e-3 * L):
        raise AssertionError(
            "nmt beam search: logits at real positions %.3g from dense, "
            "worst chosen extension %.3g below the dense 4th, replay equal "
            "%s, scores %.3g from the dense recomputation"
            % (logit_err, shortfall,
               np.array_equal(replay_seqs, seqs[:, :, 1:n_steps + 1]),
               score_err))
    device_ms = [st["device_ms"] for st in probe.steps]
    d2h_mb = probe.steps[0]["d2h_bytes"] / 1e6
    d2h_ms = [st["d2h_ms"] for st in probe.steps]
    accuracy = float((seqs[:, 0, 1:L] == src[:, :L - 1]).mean())
    del main, loss, exe, scope, probe
    torch.cuda.empty_cache()

    control = nmt_control_flow(dev)
    launches = {k: train_launches[k] + beam_launches[k]
                for k in train_launches}
    return {
        "phase": "nmt", "model": "transformer-base", "batch": NMT_BATCH,
        "src_len": NMT_SRC, "tgt_len": NMT_TGT, "program_ops": n_ops,
        "build_and_startup_s": build_s,
        "flash_vs_dense_step1": {
            "loss_flash": loss_flash, "loss_dense": loss_dense,
            "loss_rel": loss_rel, "loss_rtol": NMT_LOSS_RTOL,
            "max_rel_norm": rel[worst], "worst_param": worst,
            "median_rel_norm": float(np.median(list(rel.values()))),
            "params": len(rel), "tolerance": GRAD_REL_TOL,
            "grad_norm": gnorm, "k_bias_grad_norm_max": zero_norm,
            "k_bias_grad_share_limit": NMT_ZERO_GRAD_SHARE,
            "launches_per_step": per_step},
        "learning": {"task": "copy", "steps": NMT_STEPS, "losses": losses,
                     "learning_rate": NMT_LR, "warmup_steps": NMT_WARMUP,
                     "margin": NMT_LEARN_MARGIN, "counter": counts[:NMT_STEPS],
                     "launches": train_launches, "step_ms": ms,
                     "step_ms_p50": p50,
                     "target_tokens_per_s_p50": tokens / (p50 / 1e3),
                     "peak_mem_mib": peak, "profile_step": prof,
                     "device_idle_share": prof["device_idle_share"]},
        "beam_search": {
            "sources": N, "beam": K, "len": L, "steps": n_steps,
            "launches": beam_launches, "flash_fwd_per_step": per_step,
            "real_logit_max_err": logit_err, "logit_atol": LOGIT_ATOL,
            "worst_shortfall_vs_dense_kth": shortfall,
            "dense_score_max_err": score_err, "score_atol": 1e-3 * L,
            "best_beam_copy_accuracy": accuracy,
            "step_device_ms_p50": float(np.median(device_ms)),
            "step_d2h_ms_p50": float(np.median(d2h_ms)),
            "d2h_mb_per_step": d2h_mb,
            "step_device_ms": device_ms, "step_d2h_ms": d2h_ms},
        "control_flow": control,
        "seconds": time.perf_counter() - t_phase,
    }, {"nmt": launches}


# ---------------------------------------------------------------------------
# phase 17: LeNet and ResNet-50 through the Executor
# ---------------------------------------------------------------------------


def image_feed(batch, channels, size, classes, seed):
    rng = np.random.default_rng(seed)
    return {"img": rng.standard_normal((batch, channels, size, size),
                                       dtype=np.float32),
            "label": rng.integers(0, classes, (batch, 1))}


def vision_program(build, place):
    """``build()`` under a fresh name guard, its startup run on ``place``.
    Returns (main, startup, loss, acc, executor, scope)."""
    from paddle_tpu_torch import fluid

    with fluid.unique_name.guard():
        main, startup, _feeds, loss, acc = build()
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return main, startup, loss, acc, exe, scope


def _conv_kernels(prof):
    """The convolution kernels a profiled step ran (cuDNN's and CUTLASS's
    names), by name."""
    keys = ("conv", "fprop", "dgrad", "wgrad", "implicit")
    return sorted(k for k in prof["kernel_calls"]
                  if any(s in k.lower() for s in keys))


def vision_phase(dev):
    """LeNet (SGD, 20 steps that must learn) and ResNet-50 (Momentum:
    step 1 at batch 4 against the same program on the CPU, 10 timed steps
    at batch 32, one AMP step with bf16 convolutions) through
    ``fluid.Executor(CUDAPlace(0))``, TF32 off."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import lenet, resnet

    t_phase = time.perf_counter()
    card = fluid.CUDAPlace(0)
    main, _s, loss, acc, exe, scope = vision_program(
        lambda: lenet.build_lenet_train(learning_rate=LENET_LR), card)
    feed = image_feed(LENET_BATCH, 1, 28, 10, seed=6)
    lenet_losses, lenet_ms = timed_steps(
        loss_step(exe, main, loss, feed, scope), LENET_STEPS)
    lenet_acc = float(exe.run(main, feed=feed, fetch_list=[acc],
                              scope=scope)[0].reshape(-1)[0])
    if not all(np.isfinite(lenet_losses)) or not np.mean(
            lenet_losses[-5:]) < np.mean(lenet_losses[:5]):
        raise AssertionError("lenet loss did not fall: %r" % (lenet_losses,))
    del main, loss, acc, exe, scope

    # ResNet-50, step 1 at batch 4: the card against the CPU
    build = lambda amp=False: resnet.build_resnet_train(  # noqa: E731
        50, class_num=1000, image_size=224, learning_rate=0.1, momentum=0.9,
        use_amp=amp)
    main, startup, loss, _acc, cpu_exe, cpu_scope = vision_program(
        build, fluid.CPUPlace())
    n_ops = len(main.global_block().ops)
    arrays = program_arrays(main, cpu_scope)
    exe = fluid.Executor(card)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.load_program_scope(main, scope, arrays)
    stats = [op.output(slot)[0] for op in main.global_block().ops
             if op.type == "batch_norm" for slot in ("MeanOut",
                                                     "VarianceOut")]
    feed4 = image_feed(RESNET_CHECK_BATCH, 3, 224, 1000, seed=7)
    fetch = [loss] + [n + "@GRAD" for n in RESNET_GRAD_PARAMS]
    t0 = time.perf_counter()
    got = exe.run(main, feed=feed4, fetch_list=fetch, scope=scope)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cpu_exe.run(main, feed=feed4, fetch_list=fetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    # the same step in fp64 on the CPU
    scope64 = fluid.Scope()
    cpu_exe.run(startup, scope=scope64)
    for n, a in arrays.items():
        scope64.set(n, torch.from_numpy(a.astype(np.float64)))
    exact = cpu_exe.run(main, feed=dict(feed4, img=feed4["img"].astype(
        np.float64)), fetch_list=fetch, scope=scope64)
    del arrays, scope64
    loss_rel = abs(float(got[0][0]) - float(want[0][0])) / abs(
        float(want[0][0]))
    grads = [dict(zip(RESNET_GRAD_PARAMS, r[1:])) for r in (got, want,
                                                            exact)]
    grad_rel, _n = rel_norms(grads[0], grads[1])
    card_err, _n = rel_norms(grads[0], grads[2])
    cpu_err, _n = rel_norms(grads[1], grads[2])
    stat_rel, _n = rel_norms(
        {n: scope.get(n).cpu().numpy() for n in stats},
        {n: cpu_scope.get(n).numpy() for n in stats})
    worst_stat = max(stat_rel, key=stat_rel.get)
    if not (loss_rel <= RESNET_LOSS_RTOL
            and grad_rel["fc_0.w_0"] <= RESNET_GRAD_RTOL
            and all(card_err[n] <= RESNET_F64_RATIO * cpu_err[n] + 1e-6
                    for n in RESNET_GRAD_PARAMS)
            and stat_rel[worst_stat] <= RESNET_STAT_RTOL):
        raise AssertionError(
            "resnet50 step 1, card vs CPU: loss %r vs %r, gradients %r, "
            "from fp64: card %r, CPU %r; running stat %s at %.3g"
            % (got[0], want[0], grad_rel, card_err, cpu_err, worst_stat,
               stat_rel[worst_stat]))
    del cpu_exe, cpu_scope, got, want, exact, grads

    # 10 steps at batch 32 (the weights after step 1), timed
    feed = image_feed(RESNET_BATCH, 3, 224, 1000, seed=8)
    step = loss_step(exe, main, loss, feed, scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = timed_steps(step, RESNET_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(losses)):
        raise AssertionError("resnet50 losses %r" % (losses,))
    prof = _profile(step, reps=1)
    del main, loss, exe, scope, step
    torch.cuda.empty_cache()

    # one AMP step: bf16 convolutions
    main, _s, loss, _acc, exe, scope = vision_program(lambda: build(True),
                                                      card)
    amp_ops = len(main.global_block().ops)
    amp_step = loss_step(exe, main, loss, feed, scope)
    amp_loss = amp_step()
    amp_prof = _profile(amp_step, reps=1)
    del main, loss, exe, scope, amp_step
    torch.cuda.empty_cache()
    convs = _conv_kernels(amp_prof)
    bf16 = [k for k in convs if "bf16" in k.lower() or "bfloat16" in k.lower()]
    if not np.isfinite(amp_loss) or not bf16:
        raise AssertionError("resnet50 amp step: loss %r, convolution "
                             "kernels %r" % (amp_loss, convs))
    p50 = float(np.median(ms[1:]))
    return {
        "phase": "vision",
        "lenet": {"batch": LENET_BATCH, "learning_rate": LENET_LR,
                  "steps": LENET_STEPS, "losses": lenet_losses,
                  "accuracy_after": lenet_acc, "step_ms": lenet_ms,
                  "step_ms_p50": float(np.median(lenet_ms[1:]))},
        "resnet50": {
            "program_ops": n_ops, "batch": RESNET_BATCH,
            "step1_vs_cpu": {"batch": RESNET_CHECK_BATCH,
                             "loss_rel": loss_rel, "loss_rtol":
                             RESNET_LOSS_RTOL, "grad_rel": grad_rel,
                             "grad_rtol": RESNET_GRAD_RTOL,
                             "card_grad_rel_vs_fp64": card_err,
                             "cpu_grad_rel_vs_fp64": cpu_err,
                             "fp64_ratio": RESNET_F64_RATIO,
                             "stat_max_rel": stat_rel[worst_stat],
                             "stat_worst": worst_stat,
                             "stat_rtol": RESNET_STAT_RTOL,
                             "stats": len(stats), "card_step_s": card_s,
                             "cpu_step_s": cpu_s},
            "losses": losses, "step_ms": ms, "step_ms_p50": p50,
            "images_per_s_p50": RESNET_BATCH / (p50 / 1e3),
            "peak_mem_mib": peak,
            "device_idle_share": prof["device_idle_share"],
            "launches_per_step": prof["launches_per_call"],
            "profile_step": prof,
            "amp": {"program_ops": amp_ops, "loss": amp_loss,
                    "bf16_conv_kernels": bf16[:8],
                    "conv_kernels": len(convs),
                    "device_idle_share": amp_prof["device_idle_share"],
                    "wall_ms": amp_prof["wall_ms"],
                    "launches_per_step": amp_prof["launches_per_call"]}},
        "seconds": time.perf_counter() - t_phase,
    }


def gpt2_small(dev):
    """GPT-2 small's widths, random weights from seed 0."""
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(use_flash_attention=True)
    model = gpt.GPTLM(cfg, device=dev)
    gpt.load_fluid_params(model, gpt.init_fluid_params(cfg, seed=0))
    return model


ONLY_PHASES = ("engine_features", "program_train", "inference_server",
               "gateway", "fleet", "programs", "bert", "vision", "nmt")


def run_only(phases, repeat, dev, name, smi):
    """``--only``: the named phases alone, ``repeat`` times, each run's
    line printed whether it passed or not; the exit code says whether
    all passed. For chasing a phase that fails now and then."""
    failed = 0
    model = gpt2_small(dev) if "engine_features" in phases else None
    served = served_gpt2(dev) if {"inference_server", "gateway"} & set(
        phases) else None
    for run in range(repeat):
        for phase in phases:
            try:
                if phase == "engine_features":
                    line = engine_features_phase(model)[0]
                elif phase == "inference_server":
                    line = inference_server_phase(dev, served)[0]
                elif phase == "gateway":
                    line = gateway_phase(dev, served)[0]
                elif phase == "fleet":
                    line = fleet_phase(dev)[0]
                elif phase == "programs":
                    line = programs_phase(dev)[0]
                elif phase == "bert":
                    line = bert_phase(dev)[0]
                elif phase == "vision":
                    line = vision_phase(dev)
                elif phase == "nmt":
                    line = nmt_phase(dev)[0]
                else:
                    line = program_train_phase(dev)[0]
                line = dict(line, run=run, ok=True)
            except Exception as exc:  # noqa: BLE001 - reported, counted
                failed += 1
                line = {"phase": phase, "run": run, "ok": False,
                        "error": "%s: %s" % (type(exc).__name__, exc)}
            emit(dict(line, device=name, nvidia_smi=smi))
            torch.cuda.empty_cache()
    print(smi, flush=True)
    emit({"ok": not failed, "runs": repeat, "failed": failed,
          "phases": phases})
    return 1 if failed else 0


def main(argv=None):
    import argparse

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--fleet-replica"]:
        return fleet_replica_main(argv[1:])

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases to run alone after the build "
                         "(engine_features, program_train, "
                         "inference_server, gateway, fleet, programs, bert, "
                         "vision, nmt)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="with --only: how many times to run them")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    for p in only:
        if p not in ONLY_PHASES:
            ap.error("--only takes %s" % ", ".join(ONLY_PHASES))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    nvcc = _build.nvcc_path()
    nvcc_ver = None
    if nvcc:
        nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, timeout=60).stdout.strip() \
            .splitlines()[-1]
    peaks = card_peaks(name)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc, "nvcc_version": nvcc_ver,
          "device": name, "capability": list(torch.cuda.get_device_capability(0)),
          "nvidia_smi": smi, "peaks": peaks[2], "tf32": False,
          "python": sys.version.split()[0]})

    if os.path.isdir(_build.BUILD_DIR):
        shutil.rmtree(_build.BUILD_DIR)   # build from the sources, now
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {k: ptxas_report(v["log"]) for k, v in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"], "ptxas": ptxas[k]}
                      for k, v in built.items()}})
    if only:
        return run_only(only, max(args.repeat, 1), dev, name, smi)

    fwd_err, fwd_rows = kernel_flash_fwd(dev, peaks)
    dec_err, dec_row = kernel_flash_decode(dev, peaks)
    paged_err, paged_row = kernel_flash_decode_paged(dev, peaks)
    train_rows = kernel_flash_train(dev, peaks)
    bias_rows = kernel_flash_bias(dev, peaks)
    bf16_rows = kernel_flash_train_bf16(dev, peaks)
    bert_rows = kernel_flash_bert(dev, peaks)
    nmt_rows = kernel_flash_nmt(dev, peaks)
    other_forms = kernel_other_forms(dev)
    emit({"phase": "kernels", "atol": KERNEL_ATOL, "rtol": KERNEL_RTOL,
          "flash_fwd": fwd_rows, "flash_decode": dec_row,
          "flash_decode_paged": paged_row, "train": train_rows,
          "bias": bias_rows, "train_bf16": bf16_rows, "bert": bert_rows,
          "nmt_cross": nmt_rows, "other_forms": other_forms})

    model, engine, launches = engine_phase(dev)
    emit(dict(engine, device=name, nvidia_smi=smi))
    features, feature_launches = engine_features_phase(model)
    emit(dict(features, device=name, nvidia_smi=smi))
    paged_engine, paged_launches = paged_engine_phase(model)
    emit(dict(paged_engine, device=name, nvidia_smi=smi))
    emit(dict(profile_phase(model), device=name, nvidia_smi=smi))
    del model
    torch.cuda.empty_cache()
    programs, prog_launches = programs_phase(dev)
    emit(dict(programs, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    train, train_launches = train_phase(dev)
    emit(dict(train, device=name, nvidia_smi=smi))
    program, program_launches, fp32_grads = program_train_phase(dev)
    emit(dict(program, device=name, nvidia_smi=smi))
    bias_run, bias_launches = bias_phase(dev)
    emit(dict(bias_run, device=name, nvidia_smi=smi))
    amp_run, amp_launches = amp_train_phase(
        dev, program["dropout0"]["program_losses"][0], fp32_grads)
    del fp32_grads
    emit(dict(amp_run, device=name, nvidia_smi=smi))
    bert_run, bert_launches = bert_phase(dev)
    emit(dict(bert_run, device=name, nvidia_smi=smi))
    amp_launches["bert_amp"] = bert_launches["bert_amp"]
    emit(dict(vision_phase(dev), device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    nmt_run, nmt_launches = nmt_phase(dev)
    emit(dict(nmt_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    served = served_gpt2(dev)
    infer_run, infer_launches = inference_server_phase(dev, served)
    emit(dict(infer_run, device=name, nvidia_smi=smi))
    gw_run, gw_launches = gateway_phase(dev, served)
    emit(dict(gw_run, device=name, nvidia_smi=smi))
    del served
    torch.cuda.empty_cache()
    fleet_run, fleet_launches = fleet_phase(dev)
    emit(dict(fleet_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()

    fwd_main = fwd_rows[-1]   # T = 1024, the largest prefill bucket
    fwd_drop = train_rows["flash_fwd_dropout"]

    def bert_form(kname, tname):
        # the kernel at the BERT classifier's shape: non-causal, ragged
        # key bias, [24, 12, 384, 64]
        r = bert_rows[tname][kname]
        return dict({k: r[k] for k in r if k != "ms_window_spread"},
                    shape=bert_rows["shape"], causal=False)

    def nmt_form(kname, tname):
        # the kernel at the NMT's cross form: non-causal, ragged source
        # key bias, q [64, 8, 48, 64] against k/v [64, 8, 64, 64]
        r = nmt_rows[tname][kname]
        return dict({k: r[k] for k in r if k != "ms_window_spread"},
                    shape=nmt_rows["shape"], kv_shape=nmt_rows["kv_shape"],
                    causal=False)

    def train_row(kname):
        r = train_rows[kname]
        return {"name": kname, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/%s.cu" % kname,
                "launches": train_launches[kname] + program_launches[kname]
                + bert_launches["bert"][kname] + nmt_launches["nmt"][kname],
                "launches_by_path": {"train_eager": train_launches[kname],
                                     "train_program": program_launches[kname],
                                     "bert": bert_launches["bert"][kname],
                                     "nmt": nmt_launches["nmt"][kname]},
                "bert_form": bert_form(kname, "fp32"),
                "nmt_form": nmt_form(kname, "fp32"),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "bound_tensor_core_ms": r["bound_tensor_core_ms"],
                "sdpa_bwd_ms": r["sdpa_bwd_ms"],
                "sdpa_fwd_bwd_ms": r["sdpa_fwd_bwd_ms"],
                "design": r["design"]}

    replaces = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:149",
                "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:207",
                "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:262"}

    def bias_row(kname, inst):
        per_head = bias_rows["forms"]["per_head"]["kernels"][inst]
        square = bias_rows["forms"]["square"]["kernels"][inst]
        return {"name": inst, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/%s.cu" % kname,
                "replaces": replaces[kname],
                "launches": bias_launches[kname],
                "max_abs_err": max(per_head["max_abs_err"],
                                   square["max_abs_err"]),
                "ms": per_head["ms"], "plain_ms": per_head["plain_ms"],
                "bound_ms": per_head["bound_ms"],
                "bound_by": per_head["bound_by"],
                "bound_tensor_core_ms": per_head["bound_tensor_core_ms"],
                "library_ms": per_head["library_ms"],
                "sdpa_fwd_bwd_ms": per_head["sdpa_fwd_bwd_ms"],
                "bias": "per-head [1, 12, 1024, 1024]",
                "square_bias": {k: square[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "sdpa_fwd_bwd_ms", "max_abs_err")}}

    def bf16_row(kname):
        r = bf16_rows[kname]
        row = {"name": kname + "[bf16]", "route": "cuda",
               "source": "paddle_tpu_torch/csrc/%s.cu" % kname,
               "replaces": replaces[kname],
               "launches": sum(run[kname] for run in amp_launches.values()),
               "launches_by_path": {path: run[kname] for path, run
                                    in amp_launches.items()},
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "bert_form": bert_form(kname, "bf16"),
               "nmt_form": nmt_form(kname, "bf16"),
               "dtype": "bf16", "shape": bf16_rows["shape"],
               "design": r["design"],
               "bound_share": r["bound_share"], "sdpa_ratio": r["sdpa_ratio"],
               "limit_ratios": {o: bf16_rows["limit_ratios"][o] for o in
                                {"flash_fwd": ("out",), "flash_bwd_dq": ("dq",),
                                 "flash_bwd_dkv": ("dk", "dv")}[kname]}}
        if "sdpa_bwd_ms" in r:
            row["sdpa_bwd_ms"] = r["sdpa_bwd_ms"]
            row["sdpa_fwd_bwd_ms"] = r["sdpa_fwd_bwd_ms"]
        return row

    def decode_bf16_row(kname, row):
        # no path of the port (nor of the reference) serves in bf16: the
        # form is measured in the kernels phase alone, so it sits under
        # its kernel's row with no launches of its own on a main path
        r = row["bf16"]
        return {"name": kname + "[bf16]", "route": "cuda",
                "source": "paddle_tpu_torch/csrc/%s.cu" % kname,
                "launches": 0, "main_path": None,
                "max_abs_err": r["max_abs_err"],
                "out_bound_ratio": r["out_bound_ratio"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "bound_share": r["bound_share"],
                "library_ms": r["library_ms"],
                "gather_sdpa_ms": r.get("gather_sdpa_ms"),
                "repeatable": r["repeatable"]}

    def decode_design_row(kname, row):
        # split-K over a cluster, the copy ring, and the build's
        # registers and spills of every instantiation
        return {"splits": row["splits"], "cluster": row["cluster"],
                "stages": row["design"]["stages"],
                "threads": row["design"]["threads"],
                "bound_share": row["bound_share"],
                "repeatable": row["repeatable"],
                "ptxas": ptxas.get(kname, {})}

    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/kernels/flash_attention.py:149",
         "launches": launches["flash_fwd"]
         + feature_launches["flash_fwd"] + train_launches["flash_fwd"]
         + program_launches["flash_fwd"] + infer_launches["flash_fwd"]
         + gw_launches["flash_fwd"] + fleet_launches["flash_fwd"]
         + prog_launches["flash_fwd"] + bert_launches["bert"]["flash_fwd"]
         + nmt_launches["nmt"]["flash_fwd"],
         "launches_by_path": {"engine": launches["flash_fwd"],
                              "engine_features":
                                  feature_launches["flash_fwd"],
                              "train_eager": train_launches["flash_fwd"],
                              "train_program": program_launches["flash_fwd"],
                              "inference_server":
                                  infer_launches["flash_fwd"],
                              "gateway": gw_launches["flash_fwd"],
                              "fleet": fleet_launches["flash_fwd"],
                              "programs": prog_launches["flash_fwd"],
                              "bert": bert_launches["bert"]["flash_fwd"],
                              "nmt": nmt_launches["nmt"]["flash_fwd"]},
         "max_abs_err": max(fwd_err, fwd_drop["max_abs_err"]),
         "ms": fwd_main["ms"], "plain_ms": fwd_main["plain_ms"],
         "bound_ms": fwd_main["bound_ms"], "bound_by": fwd_main["bound_by"],
         "library_ms": fwd_main["library_ms"],
         "bound_tensor_core_ms": fwd_main["bound_tensor_core_ms"],
         "design": fwd_main["design"],
         "bert_form": bert_form("flash_fwd", "fp32"),
         "nmt_form": nmt_form("flash_fwd", "fp32"),
         "train_dropout": {k: fwd_drop[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "bound_tensor_core_ms", "max_abs_err")}},
        bias_row("flash_fwd", "flash_fwd+bias"),
        dict(train_row("flash_bwd_dq"), replaces=replaces["flash_bwd_dq"]),
        bias_row("flash_bwd_dq", "flash_bwd_dq+bias"),
        dict(train_row("flash_bwd_dkv"), replaces=replaces["flash_bwd_dkv"]),
        bias_row("flash_bwd_dkv", "flash_bwd_dkv+dbias"),
        bf16_row("flash_fwd"), bf16_row("flash_bwd_dq"),
        bf16_row("flash_bwd_dkv"),
        {"name": "flash_decode", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_decode.cu",
         "replaces": "paddle_tpu/kernels/flash_attention.py:363",
         "launches": launches["flash_decode"]
         + feature_launches["flash_decode"] + infer_launches["flash_decode"]
         + gw_launches["flash_decode"] + prog_launches["flash_decode"],
         "launches_by_path": {
             "engine": launches["flash_decode"],
             "engine_features": feature_launches["flash_decode"],
             "inference_server": infer_launches["flash_decode"],
             "gateway": gw_launches["flash_decode"],
             "programs": prog_launches["flash_decode"]},
         "max_abs_err": dec_err,
         "ms": dec_row["ms"], "plain_ms": dec_row["plain_ms"],
         "bound_ms": dec_row["bound_ms"], "bound_by": dec_row["bound_by"],
         "library_ms": dec_row["library_ms"],
         **decode_design_row("flash_decode", dec_row),
         "bf16": decode_bf16_row("flash_decode", dec_row)},
        {"name": "flash_decode_paged", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_decode_paged.cu",
         "replaces": "paddle_tpu/kernels/flash_attention.py:459",
         "launches": paged_launches["flash_decode_paged"]
         + gw_launches["flash_decode_paged"]
         + fleet_launches["flash_decode_paged"]
         + prog_launches["flash_decode_paged"],
         "launches_by_path": {
             "paged_engine": paged_launches["flash_decode_paged"],
             "gateway": gw_launches["flash_decode_paged"],
             "fleet": fleet_launches["flash_decode_paged"],
             "programs": prog_launches["flash_decode_paged"]},
         "max_abs_err": paged_err, "ms": paged_row["ms"],
         "plain_ms": paged_row["plain_ms"], "bound_ms": paged_row["bound_ms"],
         "bound_by": paged_row["bound_by"],
         "library_ms": paged_row["library_ms"],
         "gather_sdpa_ms": paged_row["gather_sdpa_ms"],
         **decode_design_row("flash_decode_paged", paged_row),
         "bf16": decode_bf16_row("flash_decode_paged", paged_row)},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
