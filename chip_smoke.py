#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only program_train --repeat 6
    python3 chip_smoke.py --only fleet
    python3 chip_smoke.py --only bert,vision
    python3 chip_smoke.py --only nmt
    python3 chip_smoke.py --only recompute,rnn
    python3 chip_smoke.py --only train_runtime
    python3 chip_smoke.py --only dp
    python3 chip_smoke.py --only dygraph
    python3 chip_smoke.py --only op_corpus

Needs one CUDA card and ``nvcc``; imports nothing of JAX or
``paddle_tpu``. ``--only`` runs the named phases alone after the build
(``engine_features``, ``program_train``, ``inference_server``,
``gateway``, ``fleet``, ``programs``, ``bert``, ``vision``, ``nmt``,
``recompute``, ``rnn``, ``train_runtime``, ``dp``, ``dygraph``,
``op_corpus``),
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
19. recompute  (run after nmt) activation recompute: ResNet-50 with
           ``build_resnet_train(50, recompute=True)`` beside the plain
           build at batch 32 and 128 (step-1 loss, fc's gradient and the
           running stats against the plain step's, peak
           ``torch.cuda.max_memory_allocated`` of each and their ratio,
           step ms, conv launches), one AMP step with recompute; BERT-base's
           classifier with ``RecomputeOptimizer`` (checkpoints at the 12
           encoder layers' outputs) beside the plain program at dropout
           0.1 from the same weights and generator state (step-1 loss and
           every gradient; 24 ``flash_fwd``, 12 dq and 12 dk/dv a step, no
           generic replay), peak memory and step ms.
20. rnn    the recurrent layers: the PTB LSTM LM "large" on
           ``fluid.contrib.basic_lstm`` and the IMDB stacked LSTM on
           ``dynamic_lstm`` fed by ``DataFeeder`` as LoD (lengths 16-256),
           each against the CPU at step 1 and learning on the card (step
           ms, tokens/s, idle share, launches, peak memory);
           ``DynamicRNN`` / ``StaticRNN`` / ``IfElse`` at hid 512 against
           the CPU; LSTM beam search (``BeamSearchDecoder`` +
           ``dynamic_decode``, beam 10, 50 steps, vocabulary 7709) against
           the CPU step by step, its backtrack against numpy, host syncs
           a step.
21. train_runtime  (run after rnn) GPT-2 small's train program at 8 x
           1024, fp32, fed by the training runtime: (a) 10 steps at
           dropout 0 through ``DataLoader.from_generator`` and through
           ``PyReader`` (start/reset), both double-buffered onto
           ``cuda_places()``, held bit for bit to plain numpy feeds
           (pinned staging, 10 H2D batches and 10 stream waits, 12
           launches of each training kernel a step, nothing built after
           step 1), and 10 batches mixing a LoD value (host form) with
           staged dense ones ([8, 1024, 768]) through the double-buffered
           ``DataLoader``, bit for bit their plain feeds, a stream wait
           each; (b) a producer sleeping half a step a batch: the
           double-buffered epoch at most 1.2x the numpy loop (the faster
           of two each), the unbuffered epoch beside it; (c)
           ``Executor.train_from_dataset`` over MultiSlot files through
           the native parser and queue, its losses the numpy loop's; (d)
           dropout 0.1, interval saves every 4 steps over 12: run A
           twice (bit for bit, else the relative norm), run B preempted
           by its own SIGTERM after step 6 with its final save, run C
           resumed in a fresh program and scope, held to run A, its
           generators and flash dropout seed at step 7 run A's; the
           stall and bytes per save, the writer's ms and its crc32 and
           fsync parts; (e) the armed guardian: a chaos NaN at step 9
           skipped (the state bit for bit the pre-step one), a
           constant-token batch at step 13 rolled back to the newest
           verified checkpoint, the health fetch against the summed
           squared gradients (1e-4); (f) one worker under ``python -m
           paddle_tpu_torch.distributed.launch --max_restarts 1`` over
           the first 8 batches of (d)'s stream, saving every 4 steps
           before its next step, in its own processes beside (a), (c)
           and (e) ((d) and then (b) run after it, alone), killed by
           ``chaos_crash_at_step`` after step 5 while it trains,
           restarted, resumed from its step-3 checkpoint, its final
           checkpoint held to run A's state at step 7 as in (d).
22. dp     (run after train_runtime) data-parallel training over
           ``torch.distributed``: one launch of two workers (``python -m
           paddle_tpu_torch.distributed.launch --nproc_per_node 2``, this
           script's hidden ``--dp-worker`` mode) on card 0 over gloo
           (NCCL refuses two ranks on one GPU), in the same processes:
           (a) every c_* op and its gradient on CUDA tensors, each rank's
           shard through ``CompiledProgram.with_data_parallel``, against
           numpy; the quantized sum against its bound; ``sync_batch_norm``
           against ``batch_norm`` on the joined batch; (b) BASELINE.json
           config 4, ``build_resnet_train(50)`` at 32 images a rank, fp32,
           3 steps, each rank's loss, running stats and the parameters
           after the last step held to rank 0's computation by hand (the
           plain program's gradients on each half, their mean, the
           momentum update), the ranks equal at the start and the end,
           images/s per rank and the ms a step spent in collectives; (c)
           GPT-2 small through the flash kernels, 2 ranks of 4 x 1024
           against one process on 8 x 1024 (loss, the parameters' update
           after 2 Adam steps), 12 launches of each training kernel a
           step on each rank; (d) a one-rank NCCL group (``new_group([0],
           backend="nccl")`` as ring 7) running c_allreduce_sum,
           c_broadcast and c_allgather on the card; (e) the dygraph
           phase's ``DataParallel`` LeNet (checked and reported there).
           A worker that misses
           a check exits non-zero and the launcher tears the gang down;
           a launch that outlives its timeout is killed. Both ranks share
           one card, so its rates do not show scaling.
23. dygraph  (run after dp) BERT-base's classifier written as
           ``fluid.dygraph`` Layers (``paddle_tpu_torch/testing/
           dygraph_models.py``) at seq 384 and batch 24, fp32, under
           ``fluid.dygraph.guard(CUDAPlace(0))``, beside the static
           ``build_bert_classifier`` program at the same weights, dropout
           0: 3 Adam steps each, the losses (1e-5 relative) and the
           step-1 gradients (1e-4 relative norm) held to the program's,
           12 launches of each training kernel a dygraph step, no generic
           replay, no plain flash call; the dygraph and static step ms
           p50 over 5 steps, a profiled dygraph step (idle share,
           launches); then ``DataParallel`` LeNet on 2 ranks over gloo on
           the card (run in the dp phase's ``--dp-worker`` processes, or
           in a launch of its own under ``--only dygraph``), 3 SGD steps
           held to one process on the whole batch.
24. op_corpus  (run after bert) the ops of ROADMAP A16's first two
           parts: every op type the slices ported (the math, tensor and
           optimizer ops, ``conv2d_transpose``, ``group_norm``, the rest
           of ``nn_ops.py``, the metric, loss and manipulation ops and
           ``ctc_align``, the second part's at their models' widths:
           CTC at T 200 × 29 classes × batch 16, NCE at a 50 000-word
           vocabulary, FCN's upsampling to 512 × 1024, AlexNet's lrn)
           run through its registered lowering on CUDA tensors against
           the same lowering on CPU tensors of the same inputs, forward
           and (where it has one) its gradient through the op's vjp:
           fp32 within 1e-5 of the largest value, integer and boolean
           outputs exactly, the random ops by shape, dtype and range,
           ``nce`` against the float64 numpy of its formula on the
           card's own draw, the host ops' device reads counted; FCN-32s
           on ResNet-50 (``testing/fcn.py``: 19 classes, 2 × 512 × 1024,
           fp32): the head's ops on the step's tensors against the CPU,
           ``mean_iou``'s counts against numpy's confusion count, 20
           Momentum steps on one batch whose loss falls and mean IoU
           rises, no flash kernel launched, the step p50, images/s,
           peak memory and a profiled step's idle share; BERT-base's
           classifier
           under ``fluid.optimizer.Lamb`` (``testing/bert_lamb.py``) at
           seq 384 and batch 24, fp32: 3 steps at dropout 0 whose updates
           of every layer's Q/K/V weight, a LayerNorm scale and the
           classifier weight equal a float64 numpy Lamb of the fetched
           gradients (1e-5), 12 launches of each training kernel a step,
           no generic replay, then 20 steps at dropout 0.1 whose loss
           falls (the main path), the step p50 and peak memory beside
           the bert phase's Adam step; then the other optimizers, 2 steps
           each on BERT at 2 layers and full width (seq 128, batch 8),
           every parameter and accumulator against the same program on
           the CPU (1e-5 relative norm).

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
import threading
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
# Activation recompute (ROADMAP A8) through fluid.Executor(CUDAPlace(0)).
# ResNet-50 (224x224, 1000 classes, Momentum 0.1 / 0.9) with
# build_resnet_train(50, recompute=True) (checkpoints at every other
# residual block's output) beside the plain build, from the same weights
# at batch 32 and 128: the replays recompute the same functions on the
# same inputs, so the step-1 loss within 1e-5 relative, fc's gradient and
# every batch norm's running Mean and Variance after step 1 (advanced once,
# not twice: a replay writes its own copies) within 1e-4 relative norm.
# 3 timed steps each for the step ms and torch.cuda.max_memory_allocated;
# one profiled step at batch 32 for the conv launches (the replays show as
# more convolutions). One AMP step with recompute, its loss within 1e-2 of
# the fp32 step's. BERT-base's classifier (batch 24, seq 384, Adam 1e-4,
# dropout 0.1 in the dropout ops and in the flash kernel) wrapped in
# RecomputeOptimizer with the 12 encoder layers' outputs as checkpoints,
# beside the plain program from the same weights and generator state: the
# kept dropout outputs and the replays' reuse of the forward's flash seed
# give the same masks, so the step-1 loss and every gradient within 1e-5
# relative norm (a replay with a fresh seed reads O(1));
# flash_fwd 24 a step (12 forward, 12 replays), dq and dk/dv 12 each.
RC_RESNET_BATCHES, RC_RESNET_STEPS = (32, 128), 3
RC_LOSS_RTOL, RC_GRAD_RTOL, RC_STAT_RTOL = 1e-5, 1e-4, 1e-4
RC_AMP_LOSS_RTOL = 1e-2
RC_BERT_STEPS, RC_BERT_RTOL = 3, 1e-5
# The recurrent layers (ROADMAP A14) through fluid.Executor(CUDAPlace(0)),
# each against the same program on the CPU from the same weights: the
# step-1 loss within 1e-5 relative and every gradient within 1e-4
# relative norm (floored as in the train phases), fp32 both ways. The PTB
# LSTM LM "large" (Zaremba et al. 2014, arXiv:1409.2329, as PaddleNLP's
# language_model large config): 2 layers of 1500, 35 unrolled steps,
# batch 20, vocabulary 10000, U(-0.04, 0.04), SGD at 1.0 under a global
# norm clip of 10, dropout 0.65; compared at dropout 0, then 20 steps at
# 0.65 on one batch of random ids whose last 5 losses must average 0.1
# below the first 5. The IMDB stacked LSTM (the book's stacked_lstm_net:
# embedding 128, 3 dynamic_lstm of 512 alternating direction, 2 classes,
# the synthetic reader's vocabulary of 5148, Adagrad 0.002) on 128
# reviews of 16-256 words fed by DataFeeder as LoD (real reviews run
# longer: a cut); 10 steps (20 before the train_runtime phase took their
# time) whose loss must fall. Its card-vs-CPU check
# runs on the first 16 reviews of that batch (the CPU takes ~54 s for
# the 128: a cut of the check's batch, not of the model), and its
# predictions there are held within IMDB_PLAIN_ATOL of a plain fp64
# PyTorch loop over each review's own rows (no padding, no lengths: the
# ragged semantics held apart from the port's masking). DynamicRNN, StaticRNN
# and IfElse at hid 512 over the same feed. Beam search: BeamSearchDecoder
# over one LSTMCell(512), vocabulary 7709, beam 10, at most 50 steps, 32
# sources (PaddleNLP seq2seq's IWSLT'15 en-vi widths, one layer where it
# stacks two, no attention): every step's tokens and parents equal the
# CPU's, or, apart at a near tie, the final scores within 1e-4 of their
# size; the backtrack equal to numpy's.
PTB_VOCAB, PTB_HIDDEN, PTB_LAYERS, PTB_STEPS = 10000, 1500, 2, 35
PTB_BATCH, PTB_INIT, PTB_LR, PTB_CLIP = 20, 0.04, 1.0, 10.0
PTB_DROPOUT, PTB_TRAIN_STEPS, PTB_LEARN_MARGIN = 0.65, 20, 0.1
IMDB_VOCAB, IMDB_EMB, IMDB_HID, IMDB_STACKED = 5148, 128, 512, 3
IMDB_BATCH, IMDB_MIN_LEN, IMDB_MAX_LEN = 128, 16, 256
IMDB_LR, IMDB_STEPS, IMDB_CHECK_BATCH = 0.002, 10, 16
IMDB_PLAIN_ATOL = 1e-5
CF_HID = 512
BEAM_HID, BEAM_VOCAB, BEAM_K, BEAM_STEPS, BEAM_N = 512, 7709, 10, 50, 32
BEAM_BOS, BEAM_EOS, BEAM_TIE_RTOL = 0, 1, 1e-4
RNN_LOSS_RTOL, RNN_GRAD_RTOL = 1e-5, 1e-4
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


_PHASE_SECONDS = []              # (phase, seconds since the emit before)
_LAST_EMIT = [time.perf_counter()]


def emit(obj):
    now = time.perf_counter()
    if isinstance(obj, dict) and "phase" in obj:
        _PHASE_SECONDS.append((obj["phase"], round(now - _LAST_EMIT[0], 1)))
    _LAST_EMIT[0] = now
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
    # split-K merge adds no launch. The wrappers' counts, over one more
    # step, are compared; the trace's are printed beside them and only
    # held to at most that: a trace can fall short of a step by a record
    # (``program_train_phase``)
    from paddle_tpu_torch.kernels import flash_attention as fa

    n_layers = model.cfg.num_layers
    decode_flash = {}
    for path, prof, kname, wrapper, run in (
            ("decode_step", step, "flash_decode", fa.flash_decode_attention,
             lambda: sess.decode_step([1] * slots, [500] * slots,
                                      [True] * slots)),
            ("paged_step_width1", paged[1], "flash_decode_paged",
             fa.flash_decode_paged_attention,
             lambda: psess.paged_step(np.ones((slots, 1), "int64"),
                                      [500] * slots, tables, [True] * slots,
                                      width=1))):
        wrapper.launches = 0
        run()
        torch.cuda.synchronize()
        n = wrapper.launches
        traced = prof["flash_launches_by_kernel"].get(kname, 0.0)
        if n != n_layers or not 0 < traced <= n_layers:
            raise AssertionError("%s launched %s times a %s (%s in the "
                                 "trace), not %d"
                                 % (kname, n, path, traced, n_layers))
        decode_flash[path] = {
            "kernel": kname, "device_ms": prof["flash_ms_by_kernel"][kname],
            "launches_per_step": n, "traced_launches_per_step": traced,
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
    # the wrappers' counts above are exact; the trace may lose a record
    if not 0 < prog_prof["launches_by_class"]["flash"] <= 3 * n_layers:
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


# which of the probe's trials a timing bar ("throughput"-prefixed) is in
FLEET_PROBE_TIMING_TRIALS = (("throughput: kv-tier", "kv_tier"),
                             ("throughput: scale-up", "fleet"))
FLEET_PROBE_TRIAL_KEYS = {
    "fleet": ("boot", "overhead", "failover", "autoscale", "scale_down",
              "rollout", "strict"),
    "generate_failover": ("generate_failover",),
    "kv_tier": ("kv_tier", "kv_tier_churn"),
    "controller_crash": ("controller_crash",)}


def _fleet_probe_on_card():
    """The port's closed-loop fleet probe with its replicas on the card.
    As in the CPU test, a miss of its timing bars alone (failures
    prefixed "throughput") earns one rerun; any other miss raises. The
    rerun repeats only the trials whose bars missed (``--trials``), and
    their rows replace the first run's."""
    root = os.path.dirname(os.path.abspath(__file__))
    first, trials, merged, secs = None, None, {}, 0.0
    for attempt in (1, 2):
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.fleet_probe",
               "--fast", "--device", "cuda"]
        if trials:
            cmd += ["--trials", ",".join(trials)]
        p = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                           timeout=900)
        secs += time.perf_counter() - t0
        report = None
        for ln in p.stdout.splitlines():
            if ln.startswith("REPORT "):
                report = json.loads(ln[len("REPORT "):])
        fails = (report or {}).get("failures") or []
        for t in (report or {}).get("trials", ()):
            merged.update({k: report.get(k)
                           for k in FLEET_PROBE_TRIAL_KEYS[t]})
        if p.returncode == 0 and "PROBE PASS" in p.stdout:
            break
        missed = set()
        for f in fails:
            t = next((t for pre, t in FLEET_PROBE_TIMING_TRIALS
                      if f.startswith(pre)), None)
            if t is None:      # not a timing bar: no rerun
                missed = None
                break
            missed.add(t)
        if attempt == 2 or not fails or missed is None:
            raise AssertionError(
                "fleet probe on the card failed (rc %d): %s\n%s\n%s"
                % (p.returncode, fails, p.stdout[-3000:], p.stderr[-3000:]))
        first, trials = fails, sorted(missed)
    return dict(merged, seconds=secs, attempts=attempt,
                first_attempt_failures=first, rerun_trials=trials,
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
            not 0 < n <= n_layers for n in
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
# phase 17: the op corpus (ROADMAP A16, first part): every op the slice
# ported, on the card against the same lowering on the CPU; BERT-base
# under Lamb at full width through the Executor; the other optimizers
# on BERT at 2 layers against the CPU
# ---------------------------------------------------------------------------
OC_BATCH = 24                  # BERT-base, seq 384, as the bert phase
OC_CHECK_STEPS = 3             # dropout 0: each update against numpy
OC_STEPS = 20                  # dropout 0.1: the loss must fall
OC_LR = 1e-3                   # Lamb's trust ratio scales it by |p|/|r|
OC_WD = 0.01
OC_LEARN_MARGIN = 0.05
OC_TIMED_ADAM = 6              # --only: the Adam step timed in-phase
OC_OP_RTOL = 1e-5              # card vs CPU, fp32, TF32 off
OC_UPDATE_RTOL = 1e-5
OC_OPT_RTOL = 1e-5             # a run's whole state, card vs CPU
OC_OPT_TENSOR_RTOL = 1e-4      # each tensor of it (see op_corpus_optimizers)
OC_DGC_BOUNDARY = 5e-3         # DGC entries sent on one device only
OC_SMALL = dict(num_layers=2)  # the other optimizers: 2 layers, full width
OC_SMALL_SEQ, OC_SMALL_BATCH = 128, 8
OC_SAMPLE = tuple("layer_%d_att_%s.w_0" % (i, t) for i in range(12)
                  for t in "qkv") + ("layer_5_ln1.w_0", "cls.w_0")


def _oc_u(rs, shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype(np.float32)


def op_corpus_specs():
    """{case: (op type, inputs {slot: [array]}, output slots {slot: n},
    attrs, input slots to differentiate, the output the cotangent
    meets, kind)} for every op type this slice ported: ``kind`` is
    "float" (1e-5 relative), "exact" or "random" (shape, dtype, range)."""
    rs = np.random.default_rng(24)
    u = lambda *s, lo=-1.0, hi=1.0: _oc_u(rs, s, lo, hi)  # noqa: E731
    X = u(256, 512, lo=-2.0, hi=2.0)
    pos = u(256, 512, lo=0.1, hi=0.9)
    specs = {}

    def add(name, op_type, ins, outs, attrs=None, grad=None, cot=None,
            kind="float"):
        specs[name] = (op_type, {k: v if isinstance(v, list) else [v]
                                 for k, v in ins.items()}, outs,
                       attrs or {}, grad or (), cot, kind)

    for a in ("abs", "atan", "brelu", "elu", "erf", "hard_shrink",
              "hard_sigmoid", "hard_swish", "leaky_relu", "logsigmoid",
              "relu6", "round", "sin", "soft_relu", "softplus", "softshrink",
              "softsign", "stanh", "swish", "tanh_shrink",
              "thresholded_relu"):
        add(a, a, {"X": X}, {"Out": 1}, grad=("X",), cot="Out")
    for a in ("acos", "asin", "log", "reciprocal", "rsqrt"):
        add(a, a, {"X": pos}, {"Out": 1}, grad=("X",), cot="Out")
    add("prelu", "prelu", {"X": u(8, 16, 12, 12), "Alpha": u(1, 16, 1, 1,
                                                               lo=0.1,
                                                               hi=0.5)},
        {"Out": 1}, {"mode": "channel"}, ("X", "Alpha"), "Out")
    for r in ("reduce_max", "reduce_min", "reduce_prod"):
        add(r, r, {"X": u(64, 32, 16, lo=0.5, hi=1.5)}, {"Out": 1},
            {"dim": [1, 2]}, ("X",), "Out")
    add("reduce_all", "reduce_all", {"X": u(64, 32) > -0.9}, {"Out": 1},
        {"dim": [1]}, kind="exact")
    add("reduce_any", "reduce_any", {"X": u(64, 32) > 0.9}, {"Out": 1},
        {"reduce_all": True}, kind="exact")
    add("frobenius_norm", "frobenius_norm", {"X": X}, {"Out": 1},
        grad=("X",), cot="Out")
    add("clip_by_norm", "clip_by_norm", {"X": X}, {"Out": 1},
        {"max_norm": 10.0}, ("X",), "Out")
    add("l2_normalize", "l2_normalize", {"X": X}, {"Out": 1, "Norm": 1},
        {"axis": 1, "epsilon": 1e-10}, ("X",), "Out")
    add("bmm", "bmm", {"X": u(16, 64, 48), "Y": u(16, 48, 32)}, {"Out": 1},
        grad=("X", "Y"), cot="Out")
    add("dot", "dot", {"X": X, "Y": u(256, 512)}, {"Out": 1},
        grad=("X", "Y"), cot="Out")
    add("bilinear_tensor_product", "bilinear_tensor_product",
        {"X": u(64, 32), "Y": u(64, 24), "Weight": u(16, 32, 24),
         "Bias": u(1, 16)}, {"Out": 1},
        grad=("X", "Y", "Weight", "Bias"), cot="Out")
    add("fsp", "fsp", {"X": u(8, 16, 12, 12), "Y": u(8, 24, 12, 12)},
        {"Out": 1}, grad=("X", "Y"), cot="Out")
    add("cos_sim", "cos_sim", {"X": X, "Y": u(256, 512)},
        {"Out": 1, "XNorm": 1, "YNorm": 1}, grad=("X", "Y"), cot="Out")
    add("squared_l2_distance", "squared_l2_distance",
        {"X": X, "Y": u(256, 512)}, {"Out": 1, "sub_result": 1},
        grad=("X", "Y"), cot="Out")
    add("sigmoid_cross_entropy_with_logits",
        "sigmoid_cross_entropy_with_logits",
        {"X": X, "Label": (u(256, 512) > 0).astype(np.float32)},
        {"Out": 1}, {"normalize": True}, ("X",), "Out")
    add("huber_loss", "huber_loss", {"X": u(256, 1, lo=-3, hi=3),
                                     "Y": u(256, 1)},
        {"Out": 1, "Residual": 1}, {"delta": 1.0}, ("X", "Y"), "Out")
    add("smooth_l1_loss", "smooth_l1_loss", {"X": u(256, 8, lo=-3, hi=3),
                                             "Y": u(256, 8)},
        {"Out": 1, "Diff": 1}, {"sigma": 1.0}, ("X", "Y"), "Out")
    add("maximum", "maximum", {"X": X, "Y": u(256, 512)}, {"Out": 1},
        grad=("X", "Y"), cot="Out")
    add("sign", "sign", {"X": X}, {"Out": 1})
    add("maxout", "maxout", {"X": u(8, 16, 12, 12)}, {"Out": 1},
        {"groups": 2}, ("X",), "Out")
    add("unfold", "unfold", {"X": u(8, 16, 12, 12)}, {"Y": 1},
        {"kernel_sizes": [3, 3], "strides": [2, 2],
         "paddings": [1, 1, 1, 1], "dilations": [1, 1]}, ("X",), "Y")
    add("add_position_encoding", "add_position_encoding",
        {"X": u(8, 128, 64)}, {"Out": 1}, {"alpha": 1.0, "beta": 1.0},
        ("X",), "Out")
    add("similarity_focus", "similarity_focus", {"X": u(4, 3, 16, 20)},
        {"Out": 1}, {"axis": 1, "indexes": [0, 2]}, kind="exact")
    add("sampling_id", "sampling_id", {"X": np.full((512, 10), 0.1,
                                                    np.float32)},
        {"Out": 1}, kind="random")
    add("uniform_random_batch_size_like", "uniform_random_batch_size_like",
        {"Input": X}, {"Out": 1}, {"shape": [-1, 64], "min": -2.0,
                                   "max": 3.0, "dtype": 5}, kind="random")
    # tensor_ops.py
    add("reshape", "reshape", {"X": X}, {"Out": 1}, {"shape": [512, 256]},
        ("X",), "Out")
    add("transpose", "transpose", {"X": X}, {"Out": 1}, {"axis": [1, 0]},
        ("X",), "Out")
    add("squeeze", "squeeze", {"X": u(256, 1, 512)}, {"Out": 1},
        {"axes": [1]}, ("X",), "Out")
    add("unsqueeze", "unsqueeze", {"X": X}, {"Out": 1}, {"axes": [1]},
        ("X",), "Out")
    for f in ("flatten", "flatten2"):
        add(f, f, {"X": u(8, 16, 12, 12)}, {"Out": 1}, {"axis": 2},
            ("X",), "Out")
    add("range", "range", {"Start": np.array([1.0], np.float32),
                           "End": np.array([700.5], np.float32),
                           "Step": np.array([0.5], np.float32)},
        {"Out": 1})
    add("fill_zeros_like", "fill_zeros_like", {"X": X}, {"Out": 1},
        kind="exact")
    add("fill_any_like", "fill_any_like", {"X": X}, {"Out": 1},
        {"value": 2.5, "dtype": -1}, kind="exact")
    add("fill", "fill", {}, {"Out": 1}, {"shape": [2, 3], "dtype": 5,
                                         "value": [1, 2, 3, 4, 5, 6.5]},
        kind="exact")
    add("fill_zeros_like2", "fill_zeros_like2", {"X": X}, {"Out": 1},
        {"dtype": 5}, kind="exact")
    add("linspace", "linspace", {"Start": np.array([-1.0], np.float32),
                                 "Stop": np.array([2.0], np.float32),
                                 "Num": np.array([1000], np.int32)},
        {"Out": 1})
    add("diag", "diag", {"Diagonal": u(300)}, {"Out": 1}, kind="exact")
    add("eye", "eye", {}, {"Out": 1}, {"num_rows": 300, "num_columns": 200,
                                       "dtype": 5}, kind="exact")
    add("gaussian_random_batch_size_like", "gaussian_random_batch_size_like",
        {"Input": X}, {"Out": 1}, {"shape": [-1, 64], "mean": 1.0,
                                   "std": 2.0, "dtype": 5}, kind="random")
    add("share_data", "share_data", {"X": X}, {"Out": 1}, grad=("X",),
        cot="Out")
    add("shape", "shape", {"Input": X}, {"Out": 1}, kind="exact")
    add("size", "size", {"Input": X}, {"Out": 1}, kind="exact")
    ties = np.round(u(256, 512) * 4) / 4
    add("arg_max", "arg_max", {"X": ties}, {"Out": 1}, {"axis": 1},
        kind="exact")
    add("arg_min", "arg_min", {"X": ties}, {"Out": 1}, {"axis": 0},
        kind="exact")
    add("argsort", "argsort", {"X": ties}, {"Out": 1, "Indices": 1},
        {"axis": 1}, kind="exact")
    add("where_index", "where_index", {"Condition": u(64, 48) > 0.3},
        {"Out": 1}, kind="exact")
    add("isinf", "isinf", {"X": X}, {"Out": 1}, kind="exact")
    add("isnan", "isnan", {"X": np.where(X > 1.9, np.nan, X).astype(
        np.float32)}, {"Out": 1}, kind="exact")
    add("stack", "stack", {"X": [X, u(256, 512), u(256, 512)]}, {"Y": 1},
        {"axis": 1}, ("X",), "Y")
    add("unstack", "unstack", {"X": u(3, 256, 512)}, {"Y": 3},
        {"axis": 0, "num": 3}, ("X",), "Y")
    add("scatter", "scatter", {"X": X, "Ids": np.arange(0, 256, 3),
                               "Updates": u(86, 512)}, {"Out": 1},
        {"overwrite": False}, ("X", "Updates"), "Out")
    add("pad", "pad", {"X": X}, {"Out": 1},
        {"paddings": [1, 2, 3, 0], "pad_value": 0.5}, ("X",), "Out")
    add("pad2d", "pad2d", {"X": u(8, 16, 12, 12)}, {"Out": 1},
        {"paddings": [1, 2, 0, 1], "mode": "reflect"}, ("X",), "Out")
    add("reverse", "reverse", {"X": X}, {"Out": 1}, {"axis": [0, 1]},
        ("X",), "Out")
    add("lookup_table_v2", "lookup_table_v2",
        {"W": u(1000, 64), "Ids": rs.integers(0, 1000, (32, 20))},
        {"Out": 1}, {"padding_idx": 3}, ("W",), "Out")
    add("one_hot_v2", "one_hot_v2",
        {"X": rs.integers(0, 12, (32, 20, 1))}, {"Out": 1},
        {"depth": 10}, kind="exact")
    add("random_crop", "random_crop", {"X": u(8, 3, 32, 32)}, {"Out": 1},
        {"shape": [24, 24]}, kind="random")
    add("tensor_array_to_tensor", "tensor_array_to_tensor",
        {"X": u(6, 32, 64)}, {"Out": 1, "OutIndex": 1}, {"axis": 1})
    # nn_ops.py
    add("conv2d_transpose", "conv2d_transpose",
        {"Input": u(8, 16, 14, 14), "Filter": u(16, 8, 3, 3, lo=-0.3,
                                                 hi=0.3)},
        {"Output": 1}, {"strides": [2, 2], "paddings": [1, 1],
                        "dilations": [1, 1], "groups": 2},
        ("Input", "Filter"), "Output")
    add("depthwise_conv2d_transpose", "depthwise_conv2d_transpose",
        {"Input": u(8, 16, 14, 14), "Filter": u(16, 1, 3, 3, lo=-0.3,
                                                 hi=0.3)},
        {"Output": 1}, {"strides": [2, 2], "paddings": [0, 0],
                        "dilations": [2, 2]}, ("Input", "Filter"),
        "Output")
    add("group_norm", "group_norm", {"X": u(8, 16, 12, 12),
                                     "Scale": u(16, lo=0.5, hi=1.5),
                                     "Bias": u(16)},
        {"Y": 1, "Mean": 1, "Variance": 1}, {"groups": 4, "epsilon": 1e-5},
        ("X", "Scale", "Bias"), "Y")
    # optimizer_ops.py (in place: the outputs name the inputs)
    p, g = u(512, 256), u(512, 256)
    lr = np.array([0.01], np.float32)
    ppos = lambda: u(512, 256, lo=0.1, hi=1.0)  # noqa: E731
    b = lambda v: np.array([v], np.float32)  # noqa: E731
    upd = {
        "lars_momentum": ({"Velocity": u(512, 256)},
                          {"mu": 0.9, "lars_coeff": 0.001,
                           "lars_weight_decay": 0.0005}),
        "adamax": ({"Moment": u(512, 256), "InfNorm": ppos(),
                    "Beta1Pow": b(0.81)}, {}),
        "decayed_adagrad": ({"Moment": ppos()}, {"decay": 0.9}),
        "rmsprop": ({"MeanSquare": ppos(), "Moment": u(512, 256),
                     "MeanGrad": u(512, 256, lo=-0.1, hi=0.1)},
                    {"momentum": 0.5, "centered": True}),
        "adadelta": ({"AvgSquaredGrad": ppos(), "AvgSquaredUpdate": ppos()},
                     {}),
        "ftrl": ({"SquaredAccumulator": ppos(),
                  "LinearAccumulator": u(512, 256)},
                 {"l1": 0.01, "l2": 0.02}),
        "lamb": ({"Moment1": u(512, 256), "Moment2": ppos(),
                  "Beta1Pow": b(0.9), "Beta2Pow": b(0.999)},
                 {"weight_decay": 0.01}),
        "dpsgd": ({}, {"clip": 0.5, "batch_size": 4.0, "sigma": 0.0}),
        "dgc_momentum": ({"Velocity": u(512, 256), "U": u(512, 256),
                          "V": u(512, 256), "CurrentStep": b(3.0)},
                         {"mu": 0.9, "sparsity_ratio": 0.99,
                          "rampup_begin_step": 2.0}),
        "lookahead_update": ({"SlowParam": u(512, 256),
                              "Step": np.array([10], np.int64)},
                             {"alpha": 0.3, "k": 5}),
    }
    for op_type, (state, attrs) in upd.items():
        ins = {"Param": p}
        if op_type != "lookahead_update":
            ins["Grad"] = g
        if op_type not in ("adadelta", "lookahead_update"):
            ins["LearningRate"] = lr
        ins.update(state)
        add(op_type, op_type, ins, {"inplace": 1}, attrs)
    return specs


_OC_INPLACE = {"ParamOut": "Param", "VelocityOut": "Velocity",
               "MomentOut": "Moment", "InfNormOut": "InfNorm",
               "MeanSquareOut": "MeanSquare", "MeanGradOut": "MeanGrad",
               "AvgSquaredGradOut": "AvgSquaredGrad",
               "AvgSquaredUpdateOut": "AvgSquaredUpdate",
               "SquaredAccumOut": "SquaredAccumulator",
               "LinearAccumOut": "LinearAccumulator",
               "Moment1Out": "Moment1", "Moment2Out": "Moment2",
               "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow",
               "UOut": "U", "VOut": "V", "SlowParamOut": "SlowParam"}


def op_corpus_run(spec, device, cot=None):
    """One op's lowering on ``device`` (an op of the registry, run as the
    Executor runs it): {output name: numpy} and, with ``cot`` (the
    cotangent of the spec's output), {input name: gradient} through the
    op's vjp (``registry.capture_vjp``: its rule, or the autograd tape)."""
    from paddle_tpu_torch.fluid.ops import registry

    op_type, ins, outs, attrs, grad, cot_slot, _kind = spec[:7]
    inputs = {s: ["%s_%d" % (s, i) for i in range(len(v))]
              for s, v in ins.items()}
    env = {n: torch.from_numpy(np.array(a)).to(device)
           for s, v in ins.items() for n, a in zip(inputs[s], v)}
    # entries no slot names: an input's ``@SEQ_LEN`` companion
    env.update({n: torch.from_numpy(np.array(a)).to(device)
                for n, a in (spec[7] if len(spec) > 7 else {}).items()})
    if "inplace" in outs:
        outputs = {o: inputs[i] for o, i in _OC_INPLACE.items()
                   if i in inputs and not (op_type == "adamax"
                                           and i == "Beta1Pow")}
    else:
        outputs = {s: ["%s_out_%d" % (s, i) for i in range(n)]
                   for s, n in outs.items()}
    op_ = registry._FakeOp(op_type, inputs, outputs, dict(attrs))
    rng = (torch.Generator(device=device).manual_seed(7),
           torch.Generator().manual_seed(7))
    ctx = registry.LowerCtx(env=env, device=device, rng=rng)
    grads = {}
    if cot is None:
        registry.run_op(ctx, op_)
    else:
        wrt = [(n, n + "@GRAD", s) for s in grad for n in inputs[s]]
        vjp_fn, values = registry.capture_vjp(ctx, op_, wrt,
                                              [outputs[cot_slot][0]])
        env.update(values)
        got = vjp_fn((torch.from_numpy(cot).to(device),))
        grads = {n: g.detach().cpu().numpy() for (n, _g, _s), g in
                 zip(wrt, got)}
    names = sorted({n for v in outputs.values() for n in v})
    return {n: env[n].detach().cpu().numpy() for n in names}, grads


def _oc_rel(got, want):
    """max |got − want| over max |want| (1 where want is all zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    scale = float(np.abs(want).max()) if want.size else 1.0
    return float(np.abs(got - want).max() / (scale or 1.0)) \
        if want.size else 0.0


def op_corpus_ops(dev):
    """Part 1: every op type of the slice on the card against the same
    lowering on the CPU, forward and (where it has one) its gradient."""
    from paddle_tpu_torch.fluid.ops import registry

    from paddle_tpu_torch.fluid import profiler

    specs = dict(op_corpus_specs(), **op_corpus_specs_2())
    worst, failures, types, host_reads, secs = {}, [], set(), {}, {}
    cpu_dev = torch.device("cpu")
    for name, spec in specs.items():
        t_case = time.perf_counter()
        op_type, _ins, _outs, _attrs, grad, cot_slot, kind = spec[:7]
        types.add(op_type)
        cot = None
        if grad and registry.get_op_def(op_type).grad_maker is not None:
            want = op_corpus_run(spec, dev)[0]
            cot = np.random.default_rng(3).standard_normal(want[sorted(
                n for n in want if n.startswith(cot_slot))[0]].shape).astype(
                    np.float32)
        reads0 = profiler.get_counter(registry.HOST_READ_COUNTER)
        card, gc = op_corpus_run(spec, dev, cot)
        if name in OC_HOST_OPS:
            host_reads[name] = profiler.get_counter(
                registry.HOST_READ_COUNTER) - reads0
        if kind == "nce":
            worst[name] = _oc_nce_error(spec, card, gc, cot)
            if worst[name] > OC_OP_RTOL:
                failures.append((name, worst[name]))
            secs[name] = time.perf_counter() - t_case
            continue
        cpu, gp = op_corpus_run(spec, cpu_dev, cot)
        errs = [_oc_rel(gc[n], gp[n]) for n in gp]
        for n, want in cpu.items():
            got = card[n]
            if kind == "random":
                ok = got.shape == want.shape and got.dtype == want.dtype
                if op_type == "sampling_id":
                    ok = ok and got.min() >= 0 and got.max() < 10
                elif op_type == "uniform_random_batch_size_like":
                    ok = ok and got.min() >= -2.0 and got.max() < 3.0
                elif op_type == "gaussian_random_batch_size_like":
                    ok = ok and abs(got.mean() - 1.0) < 0.1 and abs(
                        got.std() - 2.0) < 0.1
                else:
                    ok = ok and np.isin(got, spec[1]["X"][0]).all()
                errs.append(0.0 if ok else float("inf"))
            elif kind == "exact" or want.dtype.kind in "biu":
                errs.append(0.0 if got.dtype == want.dtype and np.array_equal(
                    got, want, equal_nan=want.dtype.kind == "f")
                    else float("inf"))
            else:
                errs.append(_oc_rel(got, want))
        worst[name] = max(errs) if errs else 0.0
        if worst[name] > OC_OP_RTOL:
            failures.append((name, worst[name]))
        secs[name] = time.perf_counter() - t_case
    if failures:
        raise AssertionError("op corpus: card vs CPU beyond %g: %r"
                             % (OC_OP_RTOL, failures))
    if any(host_reads.get(n) != k for n, k in OC_HOST_OPS.items()):
        raise AssertionError("op corpus host reads %r, want %r"
                             % (host_reads, OC_HOST_OPS))
    second = {spec[0] for spec in op_corpus_specs_2().values()}
    return {"op_types": len(types), "cases": len(specs),
            "op_types_second_slice": len(second),
            "max_rel": max(worst.values()),
            "worst_case": max(worst, key=worst.get), "rtol": OC_OP_RTOL,
            "max_rel_by_case": worst, "op_host_reads": host_reads,
            "seconds_by_case": secs}


# host ops of the second slice: the device reads each makes (its inputs
# and ``@SEQ_LEN`` companions, or the size of its output)
OC_HOST_OPS = {"edit_distance": 4, "chunk_eval": 3,
               "positive_negative_pair": 3, "unique": 1,
               "unique_with_counts": 1}


def op_corpus_specs_2():
    """The 57 op types of A16's second part (the rest of ``nn_ops.py``,
    ``metric_ops.py``, ``loss_ops.py``, ``manip_ops.py`` and
    ``ctc_align``) in ``op_corpus_specs``'s form, at the widths their
    models feed them: CTC at T 200, 29 classes, batch 16, labels of up
    to 60; NCE at a 50 000-word vocabulary, dimension 300, 5 negatives,
    batch 256; ``bilinear_interp`` at FCN's [2, 19, 16, 32] → 512 ×
    1024; ``lrn`` at AlexNet's first layer; ``instance_norm`` at [4, 64,
    256, 256]. An eighth field holds env entries no slot names (the
    ``@SEQ_LEN`` companions); kind "nce" is held to its own formula."""
    rs = np.random.default_rng(25)
    u = lambda *s, lo=-1.0, hi=1.0: _oc_u(rs, s, lo, hi)  # noqa: E731
    ints = lambda lo, hi, *s: rs.integers(lo, hi, s)  # noqa: E731
    specs = {}

    def add(name, op_type, ins, outs, attrs=None, grad=None, cot=None,
            kind="float", extra=None):
        specs[name] = (op_type, {k: v if isinstance(v, list) else [v]
                                 for k, v in ins.items()}, outs,
                       attrs or {}, grad or (), cot, kind, extra or {})

    # nn_ops.py
    add("instance_norm", "instance_norm",
        {"X": u(4, 64, 256, 256), "Scale": u(64, lo=0.5, hi=1.5),
         "Bias": u(64)}, {"Y": 1, "SavedMean": 1, "SavedVariance": 1},
        {"epsilon": 1e-5}, ("X", "Scale", "Bias"), "Y")
    add("lrn", "lrn", {"X": u(8, 96, 55, 55, lo=-4, hi=4)},
        {"Out": 1, "MidOut": 1},
        {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}, ("X",), "Out")
    score = u(2, 19, 16, 32, lo=-3, hi=3)
    add("bilinear_interp", "bilinear_interp", {"X": score}, {"Out": 1},
        {"out_h": 512, "out_w": 1024, "align_corners": True,
         "align_mode": 1}, ("X",), "Out")
    add("nearest_interp", "nearest_interp", {"X": score}, {"Out": 1},
        {"out_h": 64, "out_w": 128, "align_corners": False}, ("X",), "Out")
    add("interp_nearest", "interp_nearest", {"X": score}, {"Out": 1},
        {"scale": 3.0, "align_corners": True}, ("X",), "Out")
    add("fc", "fc", {"Input": u(256, 8, 64), "W": u(64, 128), "Bias": u(128)},
        {"Out": 1}, {"in_num_col_dims": 2, "activation_type": "relu"},
        ("Input", "W", "Bias"), "Out")
    add("max_pool2d_with_index", "max_pool2d_with_index",
        {"X": u(8, 64, 56, 56)}, {"Out": 1, "Mask": 1},
        {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, ("X",),
        "Out")
    add("max_pool3d_with_index", "max_pool3d_with_index",
        {"X": u(2, 16, 16, 32, 32)}, {"Out": 1, "Mask": 1},
        {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0]},
        ("X",), "Out")
    oi, oj = np.meshgrid(np.arange(28), np.arange(28), indexing="ij")
    win = ints(0, 4, 8, 64, 28, 28)
    add("unpool", "unpool", {"X": u(8, 64, 28, 28),
                             "Indices": ((2 * oi + win // 2) * 56
                                         + 2 * oj + win % 2).astype(
                                             np.int32)},
        {"Out": 1}, {"unpooling_type": "max", "ksize": [2, 2],
                     "strides": [2, 2], "paddings": [0, 0],
                     "unpooled_size": [56, 56]}, ("X",), "Out")
    add("spp", "spp", {"X": u(8, 64, 13, 13)}, {"Out": 1},
        {"pyramid_height": 3, "pooling_type": "max"}, ("X",), "Out")
    add("relu_grad", "relu_grad", {"Out": np.maximum(u(256, 512), 0),
                                   "Out@GRAD": u(256, 512)}, {"X@GRAD": 1})
    # metric_ops.py
    lab = ints(0, 19, 2, 512, 1024)
    lab[:, :64] = 255
    add("mean_iou", "mean_iou",
        {"Predictions": ints(0, 19, 2, 512, 1024).astype(np.int32),
         "Labels": lab.astype(np.int32)},
        {"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1},
        {"num_classes": 19})
    p1 = u(4096, lo=0.0, hi=1.0)
    add("auc", "auc", {"Predict": np.stack([1 - p1, p1], 1),
                       "Label": (rs.random((4096, 1)) < p1[:, None]).astype(
                           np.int64),
                       "StatPos": np.zeros(4096, np.int64),
                       "StatNeg": np.zeros(4096, np.int64)},
        {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1},
        {"num_thresholds": 4095})
    add("precision_recall", "precision_recall",
        {"MaxProbs": u(4096, 1, lo=0.1, hi=1.0),
         "Indices": ints(0, 10, 4096, 1), "Labels": ints(0, 10, 4096, 1),
         "Weights": u(4096, 1, lo=0.5, hi=1.5),
         "StatesInfo": np.zeros((10, 4), np.float32)},
        {"BatchMetrics": 1, "AccumMetrics": 1, "AccumStatesInfo": 1})
    add("edit_distance", "edit_distance",
        {"Hyps": ints(0, 30, 64, 40), "Refs": ints(0, 30, 64, 48)},
        {"Out": 1, "SequenceNum": 1}, {"normalized": True},
        extra={"Hyps_0@SEQ_LEN": ints(1, 41, 64).astype(np.int32),
               "Refs_0@SEQ_LEN": ints(1, 49, 64).astype(np.int32)})
    add("chunk_eval", "chunk_eval",
        {"Inference": ints(0, 9, 64, 50), "Label": ints(0, 9, 64, 50)},
        {"Precision": 1, "Recall": 1, "F1-Score": 1, "NumInferChunks": 1,
         "NumLabelChunks": 1, "NumCorrectChunks": 1},
        {"num_chunk_types": 4, "chunk_scheme": "IOB"},
        extra={"Inference_0@SEQ_LEN": ints(10, 51, 64).astype(np.int32)})
    add("positive_negative_pair", "positive_negative_pair",
        {"Score": np.round(u(512, 1), 2), "Label": ints(0, 3, 512, 1)
         .astype(np.float32), "QueryID": ints(0, 16, 512, 1)},
        {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1})
    # loss_ops.py
    logq = np.log(rs.dirichlet(np.ones(512), 256)).astype(np.float32)
    add("kldiv_loss", "kldiv_loss",
        {"X": logq, "Target": rs.dirichlet(np.ones(512), 256).astype(
            np.float32)}, {"Loss": 1}, {"reduction": "batchmean"}, ("X",),
        "Loss")
    col = lambda lo=-1.0, hi=1.0: u(4096, 1, lo=lo, hi=hi)  # noqa: E731
    binary = lambda: ints(0, 2, 4096, 1).astype(np.float32)  # noqa: E731
    add("log_loss", "log_loss", {"Predicted": col(0.05, 0.95),
                                 "Labels": binary()}, {"Loss": 1},
        {"epsilon": 1e-4}, ("Predicted",), "Loss")
    add("hinge_loss", "hinge_loss", {"Logits": col(-3, 3),
                                     "Labels": binary()}, {"Loss": 1},
        grad=("Logits",), cot="Loss")
    add("bpr_loss", "bpr_loss", {"X": u(256, 100), "Label": ints(0, 100, 256,
                                                                 1)},
        {"Y": 1}, grad=("X",), cot="Y")
    add("rank_loss", "rank_loss", {"Label": binary(), "Left": col(),
                                   "Right": col()}, {"Out": 1},
        grad=("Left", "Right"), cot="Out")
    add("margin_rank_loss", "margin_rank_loss",
        {"Label": binary() * 2 - 1, "X1": col(), "X2": col()},
        {"Out": 1, "Activated": 1}, {"margin": 0.1}, ("X1", "X2"), "Out")
    add("center_loss", "center_loss",
        {"X": u(256, 128), "Label": ints(0, 100, 256, 1),
         "Centers": u(100, 128), "CenterUpdateRate": np.array([0.5],
                                                             np.float32)},
        {"SampleCenterDiff": 1, "Loss": 1, "CentersOut": 1},
        {"need_update": True}, ("X",), "Loss")
    add("sigmoid_focal_loss", "sigmoid_focal_loss",
        {"X": u(1024, 80, lo=-4, hi=4), "Label": ints(0, 81, 1024, 1),
         "FgNum": np.array([700], np.int64)}, {"Out": 1},
        {"gamma": 2.0, "alpha": 0.25}, ("X",), "Out")
    probs = rs.dirichlet(np.ones(1000), 256).astype(np.float32)
    add("cross_entropy2", "cross_entropy2",
        {"X": probs, "Label": ints(0, 1000, 256, 1)},
        {"Y": 1, "MatchX": 1, "XShape": 1}, grad=("X",), cot="Y")
    add("cvm", "cvm", {"X": u(4096, 11, lo=0.0, hi=5.0),
                       "CVM": u(4096, 2, lo=0.0, hi=5.0)}, {"Y": 1},
        {"use_cvm": True}, ("X",), "Y")
    add("modified_huber_loss", "modified_huber_loss",
        {"X": col(-3, 3), "Y": binary()}, {"Out": 1, "IntermediateVal": 1},
        grad=("X",), cot="Out")
    add("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
        {"X": col(-4, 4), "Label": col(-2, 1)}, {"Y": 1},
        grad=("X",), cot="Y")
    add("warpctc", "warpctc",
        {"Logits": u(16, 200, 29, lo=-3, hi=3),
         "Label": ints(1, 29, 16, 60)}, {"Loss": 1, "WarpCTCGrad": 1},
        {"blank": 0, "norm_by_times": False}, ("Logits",), "Loss",
        extra={"Logits_0@SEQ_LEN": ints(150, 201, 16).astype(np.int32),
               "Label_0@SEQ_LEN": ints(20, 61, 16).astype(np.int32)})
    add("hierarchical_sigmoid", "hierarchical_sigmoid",
        {"X": u(256, 128), "W": u(9999, 128, lo=-0.2, hi=0.2),
         "Label": ints(0, 10000, 256, 1), "Bias": u(9999, 1)},
        {"Out": 1, "PreOut": 1}, {"num_classes": 10000},
        ("X", "W", "Bias"), "Out")
    add("nce", "nce",
        {"Input": u(256, 300), "Label": ints(0, 50000, 256, 1),
         "Weight": u(50000, 300, lo=-0.1, hi=0.1), "Bias": u(50000, 1)},
        {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1},
        {"num_total_classes": 50000, "num_neg_samples": 5, "sampler": 0,
         "seed": 0}, ("Input", "Weight"), "Cost", kind="nce")
    # manip_ops.py
    X = u(64, 128, 32)
    add("gather_nd", "gather_nd",
        {"X": X, "Index": np.stack([ints(0, 64, 512), ints(0, 128, 512)],
                                   1)}, {"Out": 1}, grad=("X",), cot="Out")
    add("scatter_nd_add", "scatter_nd_add",
        {"X": u(1000, 64), "Index": ints(0, 1000, 4096, 1),
         "Updates": u(4096, 64)}, {"Out": 1}, grad=("X", "Updates"),
        cot="Out")
    add("scatter_nd", "scatter_nd",
        {"Index": ints(0, 1000, 4096, 1), "Updates": u(4096, 64)},
        {"Out": 1}, {"shape": [1000, 64]}, ("Updates",), "Out")
    add("strided_slice", "strided_slice", {"Input": X}, {"Out": 1},
        {"axes": [0, 1, 2], "starts": [60, 1, -1], "ends": [0, 127, 0],
         "strides": [-3, 2, -1]}, ("Input",), "Out")
    add("expand_as", "expand_as", {"X": u(64, 1, 32), "target_tensor": X},
        {"Out": 1}, grad=("X",), cot="Out")
    add("multiplex", "multiplex",
        {"X": [u(1024, 64) for _ in range(4)], "Ids": ints(0, 4, 1024, 1)},
        {"Out": 1}, grad=("X",), cot="Out")
    feat = u(8, 64, 56, 56)
    add("crop", "crop", {"X": feat, "Y": u(8, 64, 32, 32),
                         "Offsets": np.array([0, 0, 5, 30], np.int32)},
        {"Out": 1}, grad=("X",), cot="Out")
    add("crop_tensor", "crop_tensor", {"X": feat}, {"Out": 1},
        {"offsets": [0, 8, 3, 4], "shape": [-1, 48, 50, -1]}, ("X",), "Out")
    add("pad_constant_like", "pad_constant_like",
        {"X": u(64, 128), "Y": u(50, 100)}, {"Out": 1}, {"pad_value": 0.5},
        ("Y",), "Out")
    ids = ints(0, 5000, 100000)
    add("unique", "unique", {"X": ids}, {"Out": 1, "Index": 1},
        kind="exact")
    add("unique_with_counts", "unique_with_counts", {"X": ids},
        {"Out": 1, "Index": 1, "Count": 1}, kind="exact")
    add("shard_index", "shard_index", {"X": ints(0, 50000, 4096, 1)},
        {"Out": 1}, {"index_num": 50000, "nshards": 8, "shard_id": 3,
                     "ignore_value": -1}, kind="exact")
    for op_type, attrs in (("space_to_depth", {"blocksize": 2}),
                           ("pixel_shuffle", {"upscale_factor": 2}),
                           ("shuffle_channel", {"group": 4}),
                           ("temporal_shift", {"seg_num": 8,
                                               "shift_ratio": 0.25}),
                           ("affine_channel", {"data_layout": "NCHW"})):
        ins = {"X": feat}
        if op_type == "affine_channel":
            ins.update(Scale=u(64), Bias=u(64))
        add(op_type, op_type, ins, {"Out": 1}, attrs, ("X",), "Out")
    Y = u(256, 512)
    add("minus", "minus", {"X": u(256, 512), "Y": Y}, {"Out": 1},
        grad=("X", "Y"), cot="Out")
    add("selu", "selu", {"X": u(256, 512, lo=-3, hi=3)}, {"Out": 1},
        grad=("X",), cot="Out")
    add("norm", "norm", {"X": Y}, {"Out": 1, "Norm": 1},
        {"axis": 1, "epsilon": 1e-10}, ("X",), "Out")
    add("l1_norm", "l1_norm", {"X": Y}, {"Out": 1}, grad=("X",), cot="Out")
    add("conv_shift", "conv_shift", {"X": Y, "Y": u(256, 5)}, {"Out": 1},
        grad=("X", "Y"), cot="Out")
    add("spectral_norm", "spectral_norm",
        {"Weight": u(512, 256, 3, 3), "U": u(512), "V": u(2304)},
        {"Out": 1}, {"dim": 0, "power_iters": 2, "eps": 1e-12},
        ("Weight",), "Out")
    add("grid_sampler", "grid_sampler",
        {"X": u(8, 64, 32, 32), "Grid": u(8, 32, 32, 2, lo=-1.1, hi=1.1)},
        {"Output": 1}, grad=("X", "Grid"), cot="Output")
    # misc_ops.py
    add("ctc_align", "ctc_align",
        {"Input": np.repeat(ints(0, 29, 64, 50), 4, axis=1)}, {"Output": 1},
        {"blank": 0, "merge_repeated": True}, kind="exact")
    return specs


def _oc_nce_error(spec, card, grads, cot):
    """``nce`` on the card against the float64 numpy of its formula
    (``loss_ops.py:422-438``) on the card's own draw: the largest
    relative error of Cost and of the Input and Weight gradients of
    Σ cot·Cost; inf when a sample lies outside [0, N)."""
    ins, attrs = spec[1], spec[3]
    x = ins["Input"][0].astype(np.float64)
    w = ins["Weight"][0].astype(np.float64)
    b = ins["Bias"][0].astype(np.float64).reshape(-1)
    lab = ins["Label"][0]
    n, k = attrs["num_total_classes"], attrs["num_neg_samples"]
    samples = card["SampleLabels_out_0"]
    if samples.dtype != np.int64 or samples.shape != (x.shape[0], k) or \
            samples.min() < 0 or samples.max() >= n:
        return float("inf")
    c = cot.astype(np.float64)[:, 0]
    cost = np.zeros(x.shape[0])
    gx, gw = np.zeros_like(x), np.zeros_like(w)
    for ids, sign, scale in ((lab, -1.0, 1.0 / lab.shape[1]),
                             (samples, 1.0, 1.0)):
        z = np.einsum("bkd,bd->bk", w[ids], x) + b[ids]
        adj = sign * (z - np.log(k / n))
        cost += scale * np.logaddexp(0.0, adj).sum(1)
        d = scale * sign / (1.0 + np.exp(-adj)) * c[:, None]
        gx += np.einsum("bk,bkd->bd", d, w[ids])
        np.add.at(gw, ids.reshape(-1), (d[..., None] * x[:, None, :])
                  .reshape(-1, x.shape[1]))
    return max(_oc_rel(card["Cost_out_0"][:, 0], cost),
               _oc_rel(grads["Input_0"], gx), _oc_rel(grads["Weight_0"], gw))


# ---------------------------------------------------------------------------
# op_corpus part 2: FCN-32s on ResNet-50 at Cityscapes' widths
# ---------------------------------------------------------------------------
FCN_DEPTH, FCN_CLASSES, FCN_HW, FCN_BATCH = 50, 19, (512, 1024), 2
FCN_STEPS = 20                 # one fixed batch: the loss must fall


def op_corpus_fcn(dev):
    """FCN-32s (``testing/fcn.py``) on ResNet-50 at 19 classes, 2 ×
    512 × 1024, fp32, through ``fluid.Executor(CUDAPlace(0))``: the
    head's ops (``bilinear_interp`` forward and backward,
    ``softmax_with_cross_entropy`` with the ignore label) on the step's
    own tensors against the CPU (1e-5 of the largest value);
    ``mean_iou``'s counts equal to a numpy confusion count of the
    fetched predictions and labels; 20 Momentum steps on one batch
    whose loss falls and mean IoU rises (first five against last five;
    no flash kernel launched); the step p50, images/s, peak memory and
    a profiled step's idle share."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.testing import fcn

    t0 = time.perf_counter()
    with fluid.unique_name.guard():
        main, startup, _f, loss, miou, pred_var = fcn.build_fcn_resnet(
            depth=FCN_DEPTH, num_classes=FCN_CLASSES, image_hw=FCN_HW)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    build_s = time.perf_counter() - t0
    ops = main.global_block().ops
    (interp,) = [o for o in ops if o.type == "bilinear_interp"]
    (xent,) = [o for o in ops if o.type == "softmax_with_cross_entropy"]
    img, lab = fcn.fcn_batch(FCN_BATCH, FCN_CLASSES, FCN_HW, seed=25)
    feed = {"img": img, "label": lab}
    fetch = [loss, miou[0], miou[1], miou[2], pred_var,
             interp.input("X")[0], xent.input("Logits")[0],
             xent.input("Label")[0]]
    out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    pred, score, logits, label2 = out[4:]
    # mean_iou's counts against numpy's confusion count
    p, t = pred.reshape(-1), lab.reshape(-1)
    inter = np.array([np.sum((p == c) & (t == c))
                      for c in range(FCN_CLASSES)])
    union = np.array([np.sum((p == c) | (t == c))
                      for c in range(FCN_CLASSES)])
    if not (np.array_equal(out[3], inter) and
            np.array_equal(out[2], union - inter)):
        raise AssertionError("fcn mean_iou counts %r / %r, numpy %r / %r"
                             % (out[3], out[2], inter, union - inter))
    # the head's ops at this width, card against CPU
    head = {
        "bilinear_interp": ("bilinear_interp", {"X": [score]}, {"Out": 1},
                            dict(interp.attrs), ("X",), "Out", "float"),
        "softmax_with_cross_entropy": (
            "softmax_with_cross_entropy", {"Logits": [logits],
                                           "Label": [label2]},
            {"Softmax": 1, "Loss": 1},
            {k: v for k, v in xent.attrs.items() if not k.startswith("__")},
            ("Logits",), "Loss", "float")}
    head_err = {}
    for name, spec in head.items():
        shape = op_corpus_run(spec, dev)[0][spec[5] + "_out_0"].shape
        cot = np.random.default_rng(5).standard_normal(shape).astype(
            np.float32)
        card, gc = op_corpus_run(spec, dev, cot)
        cpu, gp = op_corpus_run(spec, torch.device("cpu"), cot)
        head_err[name] = max([_oc_rel(card[n], cpu[n]) for n in cpu]
                             + [_oc_rel(gc[n], gp[n]) for n in gp])
    if max(head_err.values()) > OC_OP_RTOL:
        raise AssertionError("fcn head ops, card vs CPU: %r" % head_err)
    del out, score, logits, label2

    # the main path: 20 Momentum steps on the fixed batch
    def step():
        lv, iou = exe.run(main, feed=feed, fetch_list=[loss, miou[0]],
                          scope=scope)
        return float(lv.reshape(-1)[0]), float(iou.reshape(-1)[0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    got, ms = timed_steps(step, FCN_STEPS)
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses, ious = [g[0] for g in got], [g[1] for g in got]
    if not all(np.isfinite(losses)) or not (
            np.mean(losses[-5:]) < np.mean(losses[:5])
            and np.mean(ious[-5:]) > np.mean(ious[:5])):
        raise AssertionError("fcn did not learn: losses %r, mean IoU %r"
                             % (losses, ious))
    if any(launches.values()):
        raise AssertionError("fcn launched flash kernels: %r" % launches)
    prof = _profile(step, reps=1)
    p50 = float(np.median(ms[1:]))
    del main, exe, scope
    torch.cuda.empty_cache()
    return {"depth": FCN_DEPTH, "classes": FCN_CLASSES,
            "image_hw": list(FCN_HW), "batch": FCN_BATCH,
            "program_ops": len(ops), "build_and_startup_s": build_s,
            "mean_iou_counts_exact": True, "head_max_rel": head_err,
            "losses": losses, "mean_iou": ious, "step_ms": ms,
            "step_ms_p50": p50, "images_per_s_p50": FCN_BATCH / (p50 / 1e3),
            "peak_mem_mib": peak, "flash_launches": launches,
            "device_idle_share": prof["device_idle_share"],
            "launches_per_step": prof["launches_per_call"],
            "seconds": time.perf_counter() - t0}


def lamb_program(cfg, seq, arrays=None, lr=OC_LR, device=None):
    """BERT's classifier under Lamb (``testing.bert_lamb``), startup run
    on the card (or ``device`` "cpu"); ``arrays`` loaded in. Returns
    (main, loss, executor, scope)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.testing import bert_lamb

    with fluid.unique_name.guard():
        main, startup, _f, loss, _acc = bert_lamb.build_bert_classifier_lamb(
            cfg, seq, learning_rate=lr, lamb_weight_decay=OC_WD)
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu"
                         else fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if arrays is not None:
        fluid.load_program_scope(main, scope, arrays)
    return main, loss, exe, scope


def numpy_lamb(p, g, m1, m2, b1p, b2p, lr, wd, b1=0.9, b2=0.999, eps=1e-6):
    """The ``lamb`` update in float64 numpy from the op's fp32 inputs
    (the constants rounded to fp32 first, as the op's are): (p, m1, m2)
    after the step."""
    f = lambda v: float(np.float32(v))  # noqa: E731
    b1, b2, eps, wd = f(b1), f(b2), f(eps), f(wd)
    p, g, m1, m2 = (np.asarray(a, np.float64) for a in (p, g, m1, m2))
    m1 = b1 * m1 + (1 - b1) * g
    m2 = b2 * m2 + (1 - b2) * g * g
    r = (m1 / (1 - b1p)) / (np.sqrt(m2 / (1 - b2p)) + eps) + wd * p
    pn, rn = np.linalg.norm(p), np.linalg.norm(r)
    trust = pn / rn if pn > 0 and rn > 0 else 1.0
    return p - lr * trust * r, m1, m2


def lamb_bert_base(dev, feed, adam=None):
    """Part 2: BERT-base under Lamb at seq 384, batch 24, fp32."""
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import bert

    n_layers = bert.BertConfig.base().num_layers
    cfg0 = bert.BertConfig.base(use_flash_attention=True,
                                hidden_dropout=0.0, attention_dropout=0.0)
    t0 = time.perf_counter()
    main, loss, exe, scope = lamb_program(cfg0, BERT_SEQ)
    build_s = time.perf_counter() - t0
    n_lamb = sum(o.type == "lamb" for o in main.global_block().ops)
    arrays = program_arrays(main, scope)

    def acc(n, a):
        return scope.get("%s_%s_0" % (n, a)).detach().cpu().numpy().copy()

    checked, launches_checked = [], []
    for step in range(OC_CHECK_STEPS):
        before = {n: (scope.get(n).detach().cpu().numpy().copy(),
                      acc(n, "moment1"), acc(n, "moment2"),
                      float(acc(n, "beta1_pow_acc")[0]),
                      float(acc(n, "beta2_pow_acc")[0])) for n in OC_SAMPLE}
        replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
        zero_flash_launches()
        out = exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in OC_SAMPLE], scope=scope)
        launched = flash_launches()
        launches_checked.append(launched)
        if any(v != n_layers for v in launched.values()) or \
                profiler.get_counter(registry.REPLAY_COUNTER) != replays0:
            raise AssertionError("lamb bert step %d launched %r, replays"
                                 % (step + 1, launched))
        worst = (0.0, None)
        for n, g in zip(OC_SAMPLE, out[1:]):
            p, m1, m2, b1p, b2p = before[n]
            want_p, want_m1, want_m2 = numpy_lamb(p, g, m1, m2, b1p, b2p,
                                                  OC_LR, OC_WD)
            got_p = scope.get(n).detach().cpu().numpy()
            # the update, less the fp32 rounding of the new parameter
            # (half an ulp of it a element)
            du, dw = got_p - p, want_p - p
            ulp = np.spacing(np.abs(want_p).astype(np.float32)) / 2
            upd = float(np.linalg.norm(du - dw) - np.linalg.norm(ulp)) \
                / float(np.linalg.norm(dw))
            rel = max(upd, _oc_rel_norm(acc(n, "moment1"), want_m1),
                      _oc_rel_norm(acc(n, "moment2"), want_m2),
                      _oc_rel_norm(got_p, want_p))
            if rel > worst[0]:
                worst = (rel, n)
        checked.append({"loss": float(out[0].reshape(-1)[0]),
                        "max_rel": worst[0], "worst_param": worst[1]})
        if worst[0] > OC_UPDATE_RTOL:
            raise AssertionError("lamb bert step %d: %s off the float64 "
                                 "Lamb by %g" % (step + 1, worst[1],
                                                 worst[0]))
        del out
    del main, loss, exe, scope
    torch.cuda.empty_cache()

    # the main path: dropout 0.1, 20 Lamb steps on one fixed batch
    cfg = bert.BertConfig.base(use_flash_attention=True)
    main, loss, exe, scope = lamb_program(cfg, BERT_SEQ, arrays=arrays)
    step = loss_step(exe, main, loss, feed, scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    losses, ms = timed_steps(step, OC_STEPS)
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del main, loss, exe, scope, step
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not np.mean(
            losses[-5:]) < np.mean(losses[:5]) - OC_LEARN_MARGIN:
        raise AssertionError("lamb bert loss did not fall by %g: %r"
                             % (OC_LEARN_MARGIN, losses))
    for kname, n in launches.items():
        if n != n_layers * OC_STEPS:
            raise AssertionError("lamb bert: %s launched %d times in %d "
                                 "steps" % (kname, n, OC_STEPS))
    if adam is None:   # --only: the bert phase's Adam step, timed here
        main, aloss, _acc, exe, scope = bert_program(cfg, BERT_SEQ,
                                                     arrays=None)
        torch.cuda.reset_peak_memory_stats()
        _l, ams = timed_steps(loss_step(exe, main, aloss, feed, scope),
                              OC_TIMED_ADAM)
        adam = {"step_ms_p50": float(np.median(ams[1:])),
                "peak_mem_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
                "from": "timed in this phase (%d steps, first left out)"
                        % OC_TIMED_ADAM}
        del main, aloss, exe, scope
        torch.cuda.empty_cache()
    lamb_p50 = float(np.median(ms[1:]))
    return {"build_and_startup_s": build_s, "lamb_ops": n_lamb,
            "checked_steps": checked, "launches_checked": launches_checked,
            "update_rtol": OC_UPDATE_RTOL, "learning_rate": OC_LR,
            "weight_decay": OC_WD,
            "learning": {"steps": OC_STEPS, "losses": losses,
                         "margin": OC_LEARN_MARGIN, "launches": launches,
                         "launches_per_step": {k: v / OC_STEPS for k, v
                                               in launches.items()}},
            "lamb_step_ms": ms, "lamb_step_ms_p50": lamb_p50,
            "lamb_peak_mem_mib": peak, "adam": adam,
            "lamb_over_adam": lamb_p50 / adam["step_ms_p50"]}, launches


def _oc_rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def _oc_optimizers(fluid):
    o = fluid.optimizer
    return {
        "lars_momentum": lambda: o.LarsMomentumOptimizer(
            0.1, 0.9, lars_coeff=0.01),
        "adamax": lambda: o.Adamax(1e-4),
        "dpsgd": lambda: o.Dpsgd(0.05, clip=1.0, batch_size=8.0, sigma=0.0),
        "decayed_adagrad": lambda: o.DecayedAdagrad(1e-4),
        "adadelta": lambda: o.Adadelta(1.0),
        "rmsprop": lambda: o.RMSProp(1e-4, momentum=0.5),
        "rmsprop_centered": lambda: o.RMSProp(1e-4, centered=True),
        "ftrl": lambda: o.Ftrl(0.05, l1=1e-4, l2=1e-3),
        "dgc": lambda: o.DGCMomentumOptimizer(0.05, 0.9,
                                              rampup_begin_step=1,
                                              sparsity=[0.99]),
        "lookahead": lambda: o.LookaheadOptimizer(o.SGD(0.05), alpha=0.5,
                                                  k=2),
        "gradient_merge": lambda: o.GradientMergeOptimizer(o.SGD(0.05),
                                                           k_steps=2),
        "ema": lambda: o.SGD(0.05),
    }


def _oc_small_program(cfg, name, make):
    """BERT's classifier at ``cfg`` with optimizer ``name``; -> (main,
    startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        feeds = [layers.data(name=n, shape=[OC_SMALL_SEQ, 1], dtype="int64")
                 for n in ("src_ids", "pos_ids", "sent_ids")]
        feeds.append(layers.data(name="input_mask", shape=[OC_SMALL_SEQ, 1],
                                 dtype="float32"))
        label = layers.data(name="label", shape=[1], dtype="int64")
        _x, pooled = bert.bert_encoder(*feeds, cfg)
        logits = layers.fc(input=pooled, size=2, name="cls")
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        make().minimize(loss)
        if name == "ema":
            fluid.optimizer.ExponentialMovingAverage(0.9).update()
    return main, startup, loss


def _oc_dgc_masks(card, cpu):
    """DGC's sent entries, where the step zeroed V: {V name: (entries
    the two devices sent differently, entries sent on the CPU)}. The
    top-k threshold is a step function of V, so an entry at the boundary
    can fall either side on two devices whose gradients differ by fp32
    rounding; it then differs by its whole value in U, V and the
    parameter."""
    out = {}
    for n in card:
        if "_dgc_v_" in n:
            a, b = card[n] == 0, cpu[n] == 0
            out[n] = (int((a != b).sum()), int(b.sum()))
    return out


def op_corpus_optimizers(dev):
    """Part 3: the other optimizers, 2 steps each on BERT at 2 layers and
    full width (hidden 768, seq 128, batch 8), the same program run on
    the card and on the CPU from the card's startup values: the run's
    parameters and accumulators together within 1e-5 relative norm, each
    tensor within 1e-4 (the gradient the steps read differs by fp32
    rounding between the devices, and the normalizing updates carry
    that into values they compute from nothing: zero-initialized
    biases, FTRL's parameters). DGC (2 steps, rampup 1: a warm-up and a
    sparse step): the entries its top-k sent on one device and not the
    other (boundary ties, ``_oc_dgc_masks``) at most 0.5% of those sent,
    its U and V held elsewhere. The k-projection biases and their
    accumulators are held to 1e-5 of the whole state's norm."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig.base(use_flash_attention=True, hidden_dropout=0.0,
                               attention_dropout=0.0, **OC_SMALL)
    feeds = [bert_feed(OC_SMALL_SEQ, OC_SMALL_BATCH, seed=9 + s)
             for s in range(2)]
    out = {}
    for name, make in _oc_optimizers(fluid).items():
        t0 = time.perf_counter()
        main, startup, loss = _oc_small_program(cfg, name, make)
        states = {}
        for side in ("card", "cpu"):
            place = fluid.CUDAPlace(0) if side == "card" \
                else fluid.CPUPlace()
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            if side == "card":
                exe.run(startup, scope=scope)
                init = program_arrays(main, scope)
            else:
                for n, a in init.items():
                    scope.set(n, torch.from_numpy(a))
            with fluid.scope_guard(scope):
                for f in feeds:
                    exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            states[side] = program_arrays(main, scope)
            del exe, scope
        card, cpu = states["card"], states["cpu"]
        masks = _oc_dgc_masks(card, cpu)
        agree = {v.split("_dgc_v_")[0]: (card[v] == 0) == (cpu[v] == 0)
                 for v in masks}
        diff2 = total2 = 0.0
        rel, kb = {}, {}
        for n, want in cpu.items():
            got = card[n]
            keep = agree.get(n.split("_dgc_")[0])
            if keep is not None and keep.shape == want.shape:
                got, want = got[keep], want[keep]
            d = float(np.linalg.norm(got - want))
            w = float(np.linalg.norm(want))
            diff2, total2 = diff2 + d * d, total2 + w * w
            (kb if "_att_k.b_0" in n else rel)[n] = (d, w)
        whole = (diff2 / max(total2, 1e-60)) ** 0.5
        # the k-projection biases' exact gradient is 0 (softmax ignores a
        # shift shared by every key of a query), so their values, and
        # which of their entries DGC sends, are each side's rounding:
        # held against the whole state's norm
        kb_share = max((d for d, _w in kb.values()), default=0.0) / max(
            total2 ** 0.5, 1e-30)
        rel = {n: d / max(w, 1e-30) for n, (d, w) in rel.items()}
        worst = max(rel, key=rel.get)
        swaps = max((a / max(b, 1) for v, (a, b) in masks.items()
                     if "_att_k.b_0" not in v), default=0.0)
        out[name] = {"state_rel": whole, "max_rel": rel[worst],
                     "worst": worst, "k_bias_share": kb_share,
                     "vars": len(card), "seconds": time.perf_counter() - t0}
        if masks:
            out[name]["dgc_boundary_share"] = swaps
            out[name]["dgc_boundary_entries"] = sum(
                a for a, _b in masks.values())
        del main, startup, states, card, cpu, init
        torch.cuda.empty_cache()
    bad = {n: r for n, r in out.items()
           if max(r["state_rel"], r["k_bias_share"]) > OC_OPT_RTOL
           or r["max_rel"] > OC_OPT_TENSOR_RTOL
           or r.get("dgc_boundary_share", 0.0) > OC_DGC_BOUNDARY}
    if bad:
        raise AssertionError("optimizers on the card vs the CPU: %s"
                             % json.dumps(out))
    try:
        fluid.optimizer.ModelAverage(0.15).apply(None)
        raise AssertionError("ModelAverage.apply did not raise")
    except NotImplementedError:
        out["model_average"] = "apply raises NotImplementedError, as the " \
                               "reference's"
    return out


def op_corpus_phase(dev, adam=None):
    """The op corpus: every op the two slices ported on the card against
    the CPU; FCN-32s on ResNet-50 at Cityscapes' widths
    (``op_corpus_fcn``); BERT-base under Lamb (3 steps against float64
    numpy Lamb at dropout 0, 12 launches of each training kernel a step,
    then 20 steps at dropout 0.1 that learn: the main path, launch
    counts zeroed just before them and read just after); the other
    optimizers against the CPU. ``adam``: the bert phase's Adam step
    (timed here when None)."""
    t_phase = time.perf_counter()
    ops = op_corpus_ops(dev)
    t_ops = time.perf_counter() - t_phase
    print(json.dumps({"op_corpus_ops": ops, "seconds": t_ops}),
          file=sys.stderr, flush=True)
    fcn_run = op_corpus_fcn(dev)
    t_fcn = time.perf_counter() - t_phase - t_ops
    print(json.dumps({"op_corpus_fcn": fcn_run, "seconds": t_fcn}),
          file=sys.stderr, flush=True)
    feed = bert_feed(BERT_SEQ, OC_BATCH, seed=4)
    lamb, launches = lamb_bert_base(dev, feed, adam)
    t_lamb = time.perf_counter() - t_phase - t_ops - t_fcn
    print(json.dumps({"op_corpus_lamb": lamb, "seconds": t_lamb}),
          file=sys.stderr, flush=True)
    opts = op_corpus_optimizers(dev)
    return {"phase": "op_corpus", "ops": ops, "fcn_resnet50": fcn_run,
            "lamb_bert_base": lamb,
            "seq_len": BERT_SEQ, "batch": OC_BATCH, "optimizers": opts,
            "seconds": time.perf_counter() - t_phase,
            "seconds_by_part": {"ops": t_ops, "fcn": t_fcn, "lamb": t_lamb,
                                "optimizers": time.perf_counter() - t_phase
                                - t_ops - t_fcn - t_lamb}}, launches


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


# ---------------------------------------------------------------------------
# phase 19: activation recompute (RecomputeOptimizer) on ResNet-50 and BERT
# ---------------------------------------------------------------------------
def _stat_names(main):
    """The running Mean and Variance of every forward batch norm (a
    recompute replay writes its own ``@RECOMPUTE@`` copies)."""
    return [n for op in main.global_block().ops if op.type == "batch_norm"
            and "@RECOMPUTE@" not in op.output("MeanOut")[0]
            for n in op.input("Mean") + op.input("Variance")]


def _conv_launches(prof):
    keys = ("conv", "fprop", "dgrad", "wgrad", "implicit")
    return sum(n for k, n in prof["kernel_calls"].items()
               if any(s in k.lower() for s in keys))


def resnet_recompute_run(batch, recompute, arrays, seed, profile_it):
    """ResNet-50 (``build_resnet_train(50, recompute=...)``) on the card
    from ``arrays``: step 1 (loss, fc's gradient, the running stats after
    it), ``RC_RESNET_STEPS`` timed steps, the peak of
    ``torch.cuda.max_memory_allocated`` over them, and with
    ``profile_it`` one profiled step. Returns (row, step-1 values)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import resnet

    card = fluid.CUDAPlace(0)
    t0 = time.perf_counter()
    main, _s, loss, _acc, exe, scope = vision_program(
        lambda: resnet.build_resnet_train(
            50, class_num=1000, image_size=224, learning_rate=0.1,
            momentum=0.9, recompute=recompute), card)
    build_s = time.perf_counter() - t0
    fluid.load_program_scope(main, scope, arrays)
    stats = _stat_names(main)
    feed = image_feed(batch, 3, 224, 1000, seed=seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
    got = exe.run(main, feed=feed, fetch_list=[loss, "fc_0.w_0@GRAD"],
                  scope=scope)
    replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
    step1 = {"loss": float(got[0].reshape(-1)[0]), "fc_grad": got[1],
             "stats": {n: scope.get(n).cpu().numpy() for n in stats}}
    losses, ms = timed_steps(loss_step(exe, main, loss, feed, scope),
                             RC_RESNET_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    row = {"batch": batch, "program_ops": len(main.global_block().ops),
           "build_s": build_s, "generic_replays": replays,
           "step1_loss": step1["loss"], "losses": losses, "step_ms": ms,
           "step_ms_p50": float(np.median(ms)),
           "images_per_s_p50": batch / (np.median(ms) / 1e3),
           "peak_mem_mib": peak, "batch_norm_stats": len(stats)}
    if profile_it:
        prof = _profile(loss_step(exe, main, loss, feed, scope), reps=1)
        row.update(device_idle_share=prof["device_idle_share"],
                   launches_per_step=prof["launches_per_call"],
                   conv_launches_per_step=_conv_launches(prof),
                   device_busy_ms=prof["device_busy_ms"])
    if replays or not all(np.isfinite(losses + [step1["loss"]])):
        raise AssertionError("resnet50 recompute=%s batch %d: %d generic "
                             "replays, losses %r" % (recompute, batch,
                                                     replays, losses))
    del main, loss, exe, scope
    torch.cuda.empty_cache()
    return row, step1


def bert_recompute_program(cfg, seq, recompute, lr=BERT_LR):
    """``build_bert_classifier(cfg, seq)``'s program with its Adam built
    here, wrapped in ``RecomputeOptimizer`` when ``recompute``: the
    checkpoints are the 12 encoder layers' outputs, picked from the built
    program as the last op of each ``encoder_layer`` (its second
    ``layer_norm``; the program's first is the embeddings'). Returns
    (main, startup, loss)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        L = fluid.layers
        ids = [L.data(name=n, shape=[seq, 1], dtype="int64")
               for n in ("src_ids", "pos_ids", "sent_ids")]
        mask = L.data(name="input_mask", shape=[seq, 1], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="int64")
        _x, pooled = bert.bert_encoder(*ids, mask, cfg)
        pooled = bert._dropout(pooled, cfg.hidden_dropout, cfg.is_test)
        logits = L.fc(input=pooled, size=2, name="cls")
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        L.accuracy(input=L.softmax(logits), label=label)
        block = main.global_block()
        norms = [o for o in block.ops if o.type == "layer_norm"]
        if len(norms) != 1 + 2 * cfg.num_layers:
            raise AssertionError("bert program has %d layer norms"
                                 % len(norms))
        opt = fluid.optimizer.Adam(learning_rate=lr)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([block.var(o.output("Y")[0])
                                  for o in norms[2::2]])
        opt.minimize(loss)
    return main, startup, loss


def recompute_phase(dev):
    """Activation recompute (``RecomputeOptimizer``, ROADMAP A8) through
    ``fluid.Executor(CUDAPlace(0))``. ResNet-50 with
    ``build_resnet_train(50, recompute=True)`` beside the plain build at
    batch 32 and 128 from the same weights: step-1 loss, fc's gradient
    and every batch norm's running stats (advanced once) against the
    plain step's, peak memory, step ms, conv launches; one AMP step with
    recompute. BERT-base's classifier (batch 24, seq 384, dropout 0.1)
    with ``RecomputeOptimizer`` over Adam, checkpoints at the 12 encoder
    layers' outputs, beside the plain program from the same weights and
    generator state: step-1 loss and every gradient, launches a step
    (the main path: counts zeroed just before the timed steps, read just
    after), peak memory, step ms."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import bert, resnet

    t_phase = time.perf_counter()
    card = fluid.CUDAPlace(0)
    main, _s, _loss, _acc, _exe, scope = vision_program(
        lambda: resnet.build_resnet_train(50, class_num=1000,
                                          image_size=224), card)
    arrays = program_arrays(main, scope)
    del main, _s, _loss, _acc, _exe, scope
    resnet_rows = {}
    for batch in RC_RESNET_BATCHES:
        plain, p1 = resnet_recompute_run(batch, False, arrays, 30 + batch,
                                         batch == RC_RESNET_BATCHES[0])
        rec, r1 = resnet_recompute_run(batch, True, arrays, 30 + batch,
                                       batch == RC_RESNET_BATCHES[0])
        loss_rel = abs(r1["loss"] - p1["loss"]) / abs(p1["loss"])
        grad_rel = float(np.linalg.norm(r1["fc_grad"] - p1["fc_grad"])
                         / np.linalg.norm(p1["fc_grad"]))
        stat_rel, _n = rel_norms(r1["stats"], p1["stats"])
        worst = max(stat_rel, key=stat_rel.get)
        moved = min(float(np.linalg.norm(p1["stats"][n] - arrays[n]))
                    for n in p1["stats"])
        if not (loss_rel <= RC_LOSS_RTOL and grad_rel <= RC_GRAD_RTOL
                and stat_rel[worst] <= RC_STAT_RTOL and moved > 0):
            raise AssertionError(
                "resnet50 recompute vs plain at batch %d: loss %r vs %r, "
                "fc gradient at %.3g, running stat %s at %.3g (least move "
                "%.3g)" % (batch, r1["loss"], p1["loss"], grad_rel, worst,
                           stat_rel[worst], moved))
        resnet_rows["batch%d" % batch] = {
            "plain": plain, "recompute": rec, "loss_rel": loss_rel,
            "fc_grad_rel": grad_rel, "stat_max_rel": stat_rel[worst],
            "stat_worst": worst, "stat_least_move": moved,
            "peak_mem_ratio": rec["peak_mem_mib"] / plain["peak_mem_mib"],
            "step_ms_ratio": rec["step_ms_p50"] / plain["step_ms_p50"]}
        if "conv_launches_per_step" in rec:
            resnet_rows["batch%d" % batch]["conv_launch_ratio"] = (
                rec["conv_launches_per_step"]
                / plain["conv_launches_per_step"])
    # one AMP step with recompute (recompute inside the AMP decorator)
    main, _s, loss, _acc, exe, scope = vision_program(
        lambda: resnet.build_resnet_train(50, class_num=1000, image_size=224,
                                          use_amp=True, recompute=True),
        card)
    fluid.load_program_scope(main, scope, dict(
        arrays, loss_scaling=scope.get("loss_scaling").cpu().numpy()))
    amp_loss = float(exe.run(main, feed=image_feed(
        RC_RESNET_BATCHES[0], 3, 224, 1000, seed=30 + RC_RESNET_BATCHES[0]),
        fetch_list=[loss], scope=scope)[0].reshape(-1)[0])
    fp32_loss = resnet_rows["batch%d" % RC_RESNET_BATCHES[0]]["plain"][
        "step1_loss"]
    amp_rel = abs(amp_loss - fp32_loss) / abs(fp32_loss)
    amp_row = {"batch": RC_RESNET_BATCHES[0], "loss": amp_loss,
               "rel_vs_fp32": amp_rel, "rtol": RC_AMP_LOSS_RTOL,
               "program_ops": len(main.global_block().ops),
               "casts": sum(o.type == "cast" for o in
                            main.global_block().ops)}
    del main, _s, loss, _acc, exe, scope, arrays
    torch.cuda.empty_cache()
    if not (np.isfinite(amp_loss) and amp_rel <= RC_AMP_LOSS_RTOL):
        raise AssertionError("resnet50 amp+recompute step: loss %r against "
                             "fp32 %r" % (amp_loss, fp32_loss))

    # BERT-base: RecomputeOptimizer against the plain program, dropout 0.1
    cfg = bert.BertConfig.base(use_flash_attention=True)
    feed = bert_feed(BERT_SEQ, BERT_BATCH, seed=4)
    n_layers = cfg.num_layers
    runs, arrays = {}, None
    for rec in (False, True):
        main, startup, loss = bert_recompute_program(cfg, BERT_SEQ, rec)
        exe = fluid.Executor(card)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if arrays is None:
            arrays = program_arrays(main, scope)
        else:
            fluid.load_program_scope(main, scope, arrays)
        names = sorted(p.name for p in main.all_parameters())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
        zero_flash_launches()
        out = exe.run(main, feed=feed, fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
        step1_launches = flash_launches()
        zero_flash_launches()
        losses, ms = timed_steps(loss_step(exe, main, loss, feed, scope),
                                 RC_BERT_STEPS)
        launches = flash_launches()
        replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        prof = _profile(loss_step(exe, main, loss, feed, scope), reps=1)
        want = {"flash_fwd": n_layers * (2 if rec else 1),
                "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}
        if step1_launches != want or replays or any(
                launches[k] != want[k] * RC_BERT_STEPS for k in want):
            raise AssertionError(
                "bert recompute=%s: step 1 launched %r (expected %r), the "
                "%d timed steps %r, %d generic replays"
                % (rec, step1_launches, want, RC_BERT_STEPS, launches,
                   replays))
        runs[rec] = {
            "step1_loss": float(out[0].reshape(-1)[0]),
            "grads": dict(zip(names, out[1:])),
            "row": {"program_ops": len(main.global_block().ops),
                    "step1_launches": step1_launches,
                    "launches": launches, "generic_replays": replays,
                    "losses": losses, "step_ms": ms,
                    "step_ms_p50": float(np.median(ms)),
                    "seq_per_s_p50": BERT_BATCH / (np.median(ms) / 1e3),
                    "peak_mem_mib": peak,
                    "device_idle_share": prof["device_idle_share"],
                    "launches_per_step": prof["launches_per_call"],
                    "flash_launches_by_kernel":
                        prof["flash_launches_by_kernel"]}}
        del main, startup, loss, exe, scope, out
        torch.cuda.empty_cache()
    plain, rec = runs[False], runs[True]
    rel, _total = rel_norms(rec["grads"], plain["grads"], GRAD_NORM_FLOOR)
    worst = max(rel, key=rel.get)
    loss_rel = abs(rec["step1_loss"] - plain["step1_loss"]) / abs(
        plain["step1_loss"])
    if not (loss_rel <= RC_BERT_RTOL and rel[worst] <= RC_BERT_RTOL):
        raise AssertionError("bert recompute vs plain at dropout 0.1: loss "
                             "%r vs %r, gradient of %s at relative norm %.3g"
                             % (rec["step1_loss"], plain["step1_loss"],
                                worst, rel[worst]))
    bert_launches = rec["row"]["launches"]
    return {
        "phase": "recompute",
        "resnet50": dict(resnet_rows, amp_recompute=amp_row,
                         checkpoints="every other residual block's output "
                                     "(ckpts[1::2], 8 of 16)",
                         loss_rtol=RC_LOSS_RTOL, grad_rtol=RC_GRAD_RTOL,
                         stat_rtol=RC_STAT_RTOL),
        "bert": {"model": "bert-base", "seq_len": BERT_SEQ,
                 "batch": BERT_BATCH,
                 "dropout": [cfg.hidden_dropout, cfg.attention_dropout],
                 "checkpoints": n_layers, "step1_loss_rel": loss_rel,
                 "max_grad_rel": rel[worst], "worst_param": worst,
                 "params": len(rel), "rtol": RC_BERT_RTOL,
                 "plain": plain["row"], "recompute": rec["row"],
                 "peak_mem_ratio": rec["row"]["peak_mem_mib"]
                 / plain["row"]["peak_mem_mib"],
                 "step_ms_ratio": rec["row"]["step_ms_p50"]
                 / plain["row"]["step_ms_p50"]},
        "seconds": time.perf_counter() - t_phase,
    }, {"recompute_bert": bert_launches}


# ---------------------------------------------------------------------------
# phase 20: the recurrent layers on LoD feeds, and beam search
# ---------------------------------------------------------------------------
def ptb_lm_program(dropout):
    """PaddleNLP's ``language_model`` in its "large" config (Zaremba et
    al. 2014): embedding, ``fluid.contrib.basic_lstm`` (2 layers of
    1500, ``recurrent`` ops), a softmax projection, the loss summed over
    the 35 steps and averaged over the batch, SGD under a global-norm
    clip, forget bias 0. ``ptb_init`` sets the weights. (No ParamAttr is
    passed to ``basic_lstm``: one ParamAttr object given to both layers'
    cells would name, and so share, a single weight in this package and
    in the reference, whose ``LayerHelper`` sets the name on the object
    it is given.) Returns (main, startup, loss)."""
    from paddle_tpu_torch import fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="x", shape=[PTB_STEPS, 1], dtype="int64")
        y = L.data(name="y", shape=[PTB_STEPS, 1], dtype="int64")
        h0, c0 = (L.data(name=n, shape=[PTB_LAYERS, PTB_BATCH, PTB_HIDDEN],
                         dtype="float32", append_batch_size=False)
                  for n in ("init_hidden", "init_cell"))
        emb = L.embedding(x, size=[PTB_VOCAB, PTB_HIDDEN],
                          param_attr=fluid.ParamAttr(name="embedding_para"))
        if dropout:
            emb = L.dropout(emb, dropout_prob=dropout,
                            dropout_implementation="upscale_in_train")
        out, _h, _c = fluid.contrib.basic_lstm(
            emb, h0, c0, PTB_HIDDEN, num_layers=PTB_LAYERS,
            dropout_prob=dropout, forget_bias=0.0)
        if dropout:
            out = L.dropout(out, dropout_prob=dropout,
                            dropout_implementation="upscale_in_train")
        w = L.create_parameter([PTB_HIDDEN, PTB_VOCAB], "float32",
                               name="softmax_weight")
        b = L.create_parameter([PTB_VOCAB], "float32", name="softmax_bias")
        logits = L.elementwise_add(L.matmul(out, w), b)
        loss = L.softmax_with_cross_entropy(logits, y)
        loss = L.reduce_sum(L.reduce_mean(L.reshape(loss, [-1, PTB_STEPS]),
                                          dim=[0]))
        fluid.optimizer.SGD(learning_rate=PTB_LR).minimize(
            loss, grad_clip=fluid.clip.GradientClipByGlobalNorm(PTB_CLIP))
    return main, startup, loss


def ptb_init(main, scope):
    """Every PTB weight U(-0.04, 0.04) and the LSTM biases 0, drawn with
    numpy from a seed, set in ``scope`` (on its device)."""
    rng = np.random.default_rng(53)
    for p in sorted(main.all_parameters(), key=lambda v: v.name):
        t = scope.get(p.name)
        if p.name.endswith(".b_0"):
            val = np.zeros(tuple(t.shape), np.float32)
        else:
            val = rng.uniform(-PTB_INIT, PTB_INIT, tuple(t.shape)).astype(
                np.float32)
        t.copy_(torch.from_numpy(val))


def imdb_samples(batch, seed):
    """[(ids, [label])] of ``batch`` reviews, lengths drawn from
    IMDB_MIN_LEN..IMDB_MAX_LEN, built as the reference's synthetic IMDB
    reader builds its reviews (``paddle_tpu/dataset/imdb.py``: 70% of a
    positive review's words from the vocabulary's upper half, 70% of a
    negative one's from the lower half, the rest from all of it)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batch):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(IMDB_MIN_LEN, IMDB_MAX_LEN + 1))
        lo, hi = ((IMDB_VOCAB // 2, IMDB_VOCAB) if label
                  else (0, IMDB_VOCAB // 2))
        main = rng.randint(lo, hi, size=int(length * 0.7))
        noise = rng.randint(0, IMDB_VOCAB, size=length - len(main))
        seq = np.concatenate([main, noise])
        rng.shuffle(seq)
        out.append((seq.astype(np.int64).tolist(), [label]))
    return out


def imdb_program():
    """The PaddlePaddle book's ``stacked_lstm_net`` (understand_sentiment)
    at its widths: embedding 128, 3 stacked ``dynamic_lstm`` of 512
    alternating direction over ``fc`` projections (``num_flatten_dims=2``
    on the padded [N, T, ...] batch), max ``sequence_pool`` of the last
    fc and LSTM, a softmax over 2 classes, ``cross_entropy``, Adagrad.
    Returns (main, startup, [cost, prediction], [words, label])."""
    from paddle_tpu_torch import fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 19
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = L.data(name="words", shape=[-1, 1], dtype="int64",
                       lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64")
        emb = L.embedding(input=words, size=[IMDB_VOCAB, IMDB_EMB])
        fc1 = L.fc(input=emb, size=IMDB_HID * 4, num_flatten_dims=2)
        lstm1, _c = L.dynamic_lstm(input=fc1, size=IMDB_HID * 4)
        inputs = [fc1, lstm1]
        for i in range(2, IMDB_STACKED + 1):
            fc = L.fc(input=inputs, size=IMDB_HID * 4, num_flatten_dims=2)
            lstm, _c = L.dynamic_lstm(input=fc, size=IMDB_HID * 4,
                                      is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        fc_last = L.sequence_pool(input=inputs[0], pool_type="max")
        lstm_last = L.sequence_pool(input=inputs[1], pool_type="max")
        pred = L.fc(input=[fc_last, lstm_last], size=2, act="softmax")
        cost = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adagrad(learning_rate=IMDB_LR).minimize(cost)
    return main, startup, [cost, pred], [words, label]


def _plain_lstm(x, w, b, reverse):
    """One ``dynamic_lstm`` over one sequence's rows x [L, 4H], as
    Paddle's lstm op documents it: gates [candidate, input, forget,
    output] of x_t + h_{t-1} W + b, peepholes W_ic, W_fc on c_{t-1} and
    W_oc on c_t (the bias's last 3H), sigmoid gates, tanh cell and
    candidate; ``reverse`` runs from the last row to the first."""
    H = w.shape[0]
    b = b.reshape(-1)
    gb, wic, wfc, woc = b[:4 * H], b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:]
    h = c = x.new_zeros(H)
    out = [None] * x.shape[0]
    steps = range(x.shape[0])
    for t in (reversed(steps) if reverse else steps):
        g = x[t] + h @ w + gb
        i = torch.sigmoid(g[H:2 * H] + c * wic)
        f = torch.sigmoid(g[2 * H:3 * H] + c * wfc)
        c = f * c + i * torch.tanh(g[:H])
        h = torch.sigmoid(g[3 * H:] + c * woc) * torch.tanh(c)
        out[t] = h
    return torch.stack(out)


def imdb_plain_predictions(params, reviews, device):
    """``imdb_program``'s softmax outputs, one review at a time over its
    own rows in fp64: embedding, fc, the stacked LSTMs alternating
    direction, the max over the review's rows of the last fc and LSTM,
    and the softmax fc. ``params`` are the program's parameter arrays by
    name; nothing of the port runs here."""
    p = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64,
                            device=device) for k, v in params.items()}
    out = []
    for ids in reviews:
        fc = p["embedding_0.w_0"][torch.as_tensor(ids, device=device)] \
            @ p["fc_0.w_0"] + p["fc_0.b_0"]
        h = _plain_lstm(fc, p["dynamic_lstm_0.w_0"],
                        p["dynamic_lstm_0.b_0"], False)
        for i in range(1, IMDB_STACKED):
            fc = (fc @ p["fc_%d.w_0" % i] + h @ p["fc_%d.w_1" % i]
                  + p["fc_%d.b_0" % i])
            h = _plain_lstm(fc, p["dynamic_lstm_%d.w_0" % i],
                            p["dynamic_lstm_%d.b_0" % i], i % 2 == 1)
        k = IMDB_STACKED
        logits = (fc.max(0).values @ p["fc_%d.w_0" % k]
                  + h.max(0).values @ p["fc_%d.w_1" % k] + p["fc_%d.b_0" % k])
        out.append(torch.softmax(logits, -1))
    return torch.stack(out).cpu().numpy()


def control_flow_rnn_program():
    """``DynamicRNN``, ``StaticRNN`` and ``IfElse`` at hid 512 over the
    IMDB feed: each RNN embeds its step's ids and runs an fc over the
    embedding and its memory (tanh); the dynamic one's last valid step
    and the static one's average over the valid steps are joined, and
    ``IfElse`` sends each row through one of two softmax fcs by the sign
    of its mean; ``cross_entropy``, SGD. Returns (main, startup, cost,
    [words, label])."""
    from paddle_tpu_torch import fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 23
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = L.data(name="words", shape=[-1, 1], dtype="int64",
                       lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64")
        emb_attr = fluid.ParamAttr(name="cf_emb")
        outs = []
        for rnn in (L.DynamicRNN(), L.StaticRNN()):
            with rnn.block():
                w_t = rnn.step_input(words)
                e_t = L.embedding(w_t, size=[IMDB_VOCAB, IMDB_EMB],
                                  param_attr=emb_attr)
                prev = rnn.memory(shape=[CF_HID], value=0.0)
                h = L.fc(input=[e_t, prev], size=CF_HID, act="tanh")
                rnn.update_memory(prev, h)
                rnn.output(h)
            outs.append(rnn())
        feat = L.concat([L.sequence_pool(outs[0], "last"),
                         L.sequence_pool(outs[1], "average")], axis=1)
        zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(L.reduce_mean(feat, dim=[1], keep_dim=True), zero)
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(ie.input(feat), size=2, act="softmax"))
        with ie.false_block():
            ie.output(L.fc(ie.input(feat), size=2, act="softmax"))
        (pred,) = ie()
        cost = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return main, startup, cost, [words, label]


def beam_program():
    """``BeamSearchDecoder`` + ``dynamic_decode`` over one ``LSTMCell`` at
    PaddleNLP seq2seq's IWSLT'15 en-vi widths (512, target vocabulary
    7709, beam 10, at most 50 steps; one layer where it stacks two, no
    attention), started from fed encoder states. Returns (main, startup,
    [backtracked ids, final log-probs], the step op's token, parent and
    length outputs)."""
    from paddle_tpu_torch import fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 29
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        enc_h = L.data(name="enc_h", shape=[BEAM_HID], dtype="float32")
        enc_c = L.data(name="enc_c", shape=[BEAM_HID], dtype="float32")
        cell = L.LSTMCell(hidden_size=BEAM_HID, name="dec_lstm")
        dec = L.BeamSearchDecoder(
            cell, start_token=BEAM_BOS, end_token=BEAM_EOS,
            beam_size=BEAM_K,
            embedding_fn=lambda ids: L.embedding(
                ids, size=[BEAM_VOCAB, BEAM_HID],
                param_attr=fluid.ParamAttr(name="tgt_emb")),
            output_fn=lambda h: L.fc(h, size=BEAM_VOCAB, name="out_proj",
                                     bias_attr=False))
        ids, states = L.dynamic_decode(dec, inits=[enc_h, enc_c],
                                       max_step_num=BEAM_STEPS)
    (op_,) = [o for o in main.global_block().ops
              if o.type == "dynamic_decode"]
    return (main, startup, [ids, states[-1]],
            op_.output("Outputs") + op_.output("Length"))


def card_and_cpu(build, feed_fn, fetch_grads=True, init=None):
    """``build()`` run one step on the card and on the CPU from the same
    weights (the CPU's startup, then ``init(main, scope)``), fed
    ``feed_fn(main)``. Returns (card
    fetches, CPU fetches, names, (card executor, main, scope, the
    starting weights) for more card steps, card ms, CPU ms)."""
    from paddle_tpu_torch import fluid

    out, keep, names, arrays = [], None, None, None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        main, startup, fetch = build()[:3]
        fetch = fetch if isinstance(fetch, list) else [fetch]
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if arrays is None:
            if init is not None:
                init(main, scope)
            arrays = program_arrays(main, scope)
        else:
            fluid.load_program_scope(main, scope, arrays)
        names = [f if isinstance(f, str) else f.name for f in fetch]
        if fetch_grads:
            names += sorted(p.name + "@GRAD" for p in main.all_parameters())
        t0 = time.perf_counter()
        got = exe.run(main, feed=feed_fn(main), fetch_list=names,
                      scope=scope)
        out.append((got, (time.perf_counter() - t0) * 1e3))
        keep = (exe, main, scope, arrays)
    (cpu, cpu_ms), (card, card_ms) = out
    return card, cpu, names, keep, card_ms, cpu_ms


def _rel_all(card, cpu, names):
    """(loss relative difference, {grad name: relative norm})."""
    loss_rel = abs(float(card[0].reshape(-1)[0]) - float(
        cpu[0].reshape(-1)[0])) / abs(float(cpu[0].reshape(-1)[0]))
    grads = {n: (c, p) for n, c, p in zip(names, card, cpu)
             if n.endswith("@GRAD")}
    rel, _t = rel_norms({n: c for n, (c, _p) in grads.items()},
                        {n: p for n, (_c, p) in grads.items()},
                        GRAD_NORM_FLOOR)
    return loss_rel, rel


def _held(tag, loss_rel, rel):
    worst = max(rel, key=rel.get)
    if not (loss_rel <= RNN_LOSS_RTOL and rel[worst] <= RNN_GRAD_RTOL):
        raise AssertionError("%s, card vs CPU: loss at %.3g, gradient of %s "
                             "at relative norm %.3g"
                             % (tag, loss_rel, worst, rel[worst]))
    return {"loss_rel": loss_rel, "loss_rtol": RNN_LOSS_RTOL,
            "max_grad_rel": rel[worst], "worst_param": worst,
            "params": len(rel), "grad_rtol": RNN_GRAD_RTOL}


def rnn_phase(dev):
    """The recurrent layers through ``fluid.Executor(CUDAPlace(0))``, each
    model on the reference's public layers: the PTB LSTM LM "large"
    (``basic_lstm``) and the IMDB stacked LSTM (``dynamic_lstm`` over a
    ``DataFeeder`` LoD batch) against the same program on the CPU at step
    1 and learning on the card, ``DynamicRNN`` / ``StaticRNN`` /
    ``IfElse`` against the CPU, and LSTM beam search against the CPU step
    by step with its backtrack against numpy."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import executor as texec
    from paddle_tpu_torch.fluid import profiler

    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    # PTB LM large: dropout 0 against the CPU, then 20 steps at 0.65
    ptb_x = rng.integers(0, PTB_VOCAB, (PTB_BATCH, PTB_STEPS + 1))
    zeros = np.zeros((PTB_LAYERS, PTB_BATCH, PTB_HIDDEN), np.float32)
    ptb_feed = {"x": ptb_x[:, :-1, None], "y": ptb_x[:, 1:, None],
                "init_hidden": zeros, "init_cell": zeros}
    card, cpu, names, keep, card_ms, cpu_ms = card_and_cpu(
        lambda: ptb_lm_program(0.0), lambda main: ptb_feed, init=ptb_init)
    ptb_check = dict(_held("ptb lm step 1", *_rel_all(card, cpu, names)),
                     card_step1_ms=card_ms, cpu_step1_ms=cpu_ms)
    del card, cpu, keep
    main, startup, loss = ptb_lm_program(PTB_DROPOUT)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ptb_init(main, scope)
    step = loss_step(exe, main, loss, ptb_feed, scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ptb_losses, ptb_ms = timed_steps(step, PTB_TRAIN_STEPS)
    ptb_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(ptb_losses)) or not np.mean(
            ptb_losses[-5:]) <= np.mean(ptb_losses[:5]) - PTB_LEARN_MARGIN:
        raise AssertionError("ptb lm loss did not fall by %g: %r"
                             % (PTB_LEARN_MARGIN, ptb_losses))
    ptb_prof = _profile(step, reps=1)
    ptb_p50 = float(np.median(ptb_ms[1:]))
    ptb = {"config": "large", "layers": PTB_LAYERS, "hidden": PTB_HIDDEN,
           "steps": PTB_STEPS, "batch": PTB_BATCH, "vocab": PTB_VOCAB,
           "init_scale": PTB_INIT, "lr": PTB_LR, "clip": PTB_CLIP,
           "program_ops": len(main.global_block().ops),
           "step1_vs_cpu_dropout0": ptb_check,
           "dropout": PTB_DROPOUT, "losses": ptb_losses,
           "margin": PTB_LEARN_MARGIN, "step_ms": ptb_ms,
           "step_ms_p50": ptb_p50,
           "tokens_per_s_p50": PTB_BATCH * PTB_STEPS / (ptb_p50 / 1e3),
           "peak_mem_mib": ptb_peak,
           "device_idle_share": ptb_prof["device_idle_share"],
           "launches_per_step": ptb_prof["launches_per_call"],
           "device_busy_ms": ptb_prof["device_busy_ms"],
           "top": ptb_prof["top"][:4]}
    del main, startup, loss, exe, scope, step
    torch.cuda.empty_cache()

    # IMDB stacked LSTM on a DataFeeder LoD batch
    samples = imdb_samples(IMDB_BATCH, seed=43)
    lens = [len(s[0]) for s in samples]

    check_samples = samples[:IMDB_CHECK_BATCH]

    def imdb_feed(main, batch=samples):
        return fluid.DataFeeder(["words", "label"], fluid.CPUPlace(),
                                program=main).feed(batch)

    card, cpu, names, keep, card_ms, cpu_ms = card_and_cpu(
        lambda: imdb_program()[:3],
        lambda main: imdb_feed(main, check_samples))
    exe, main, scope, arrays = keep
    plain = imdb_plain_predictions(
        {p.name: arrays[p.name] for p in main.all_parameters()},
        [s[0] for s in check_samples], "cuda")
    plain_err = float(np.max(np.abs(card[1] - plain)))
    if not plain_err <= IMDB_PLAIN_ATOL:
        raise AssertionError("imdb predictions on the card %.3g from the "
                             "plain per-review loop" % plain_err)
    imdb_check = dict(_held("imdb stacked lstm step 1",
                            *_rel_all(card, cpu, names)),
                      batch=IMDB_CHECK_BATCH, of_timed_batch=True,
                      lengths=[min(len(s[0]) for s in check_samples),
                               max(len(s[0]) for s in check_samples)],
                      plain_loop_max_abs_err=plain_err,
                      plain_loop_atol=IMDB_PLAIN_ATOL,
                      card_step1_ms=card_ms, cpu_step1_ms=cpu_ms)
    feed = imdb_feed(main)
    step = loss_step(exe, main, main.global_block().var(names[0]), feed,
                     scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    imdb_losses, imdb_ms = timed_steps(step, IMDB_STEPS)
    imdb_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(imdb_losses)) or not np.mean(
            imdb_losses[-5:]) < np.mean(imdb_losses[:5]):
        raise AssertionError("imdb loss did not fall: %r" % (imdb_losses,))
    imdb_prof = _profile(step, reps=1)
    imdb_p50 = float(np.median(imdb_ms[1:]))
    imdb = {"emb": IMDB_EMB, "hid": IMDB_HID, "stacked": IMDB_STACKED,
            "vocab": IMDB_VOCAB, "batch": IMDB_BATCH,
            "lengths": [min(lens), max(lens)], "tokens": sum(lens),
            "padded_tokens": IMDB_BATCH * max(lens), "lr": IMDB_LR,
            "program_ops": len(main.global_block().ops),
            "step1_vs_cpu": imdb_check, "losses": imdb_losses,
            "step_ms": imdb_ms, "step_ms_p50": imdb_p50,
            "tokens_per_s_p50": sum(lens) / (imdb_p50 / 1e3),
            "peak_mem_mib": imdb_peak,
            "device_idle_share": imdb_prof["device_idle_share"],
            "launches_per_step": imdb_prof["launches_per_call"],
            "device_busy_ms": imdb_prof["device_busy_ms"]}
    del card, cpu, keep, exe, main, scope, step
    torch.cuda.empty_cache()

    # DynamicRNN, StaticRNN and IfElse over the same feed
    card, cpu, names, keep, card_ms, cpu_ms = card_and_cpu(
        lambda: control_flow_rnn_program()[:3], imdb_feed)
    cf = dict(_held("DynamicRNN/StaticRNN/IfElse step 1",
                    *_rel_all(card, cpu, names)),
              hid=CF_HID, card_step_ms=card_ms, cpu_step_ms=cpu_ms,
              program_ops=len(keep[1].global_block().ops))
    del card, cpu, keep
    torch.cuda.empty_cache()

    # LSTM beam search: every step's choices against the CPU's
    rs = np.random.RandomState(47)
    beam_feed = {"enc_h": rs.standard_normal((BEAM_N, BEAM_HID)).astype(
        np.float32), "enc_c": rs.standard_normal((BEAM_N, BEAM_HID)).astype(
        np.float32)}
    outs, arrays = [], None
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        main, startup, fetch, steps_out = beam_program()
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if arrays is None:
            arrays = program_arrays(main, scope)
        else:
            fluid.load_program_scope(main, scope, arrays)
        names = [fetch[0].name, fetch[1].name] + list(steps_out)
        exe.run(main, feed=beam_feed, fetch_list=names, scope=scope)
        syncs0 = profiler.get_counter(texec.HOST_SYNC_COUNTER)
        t0 = time.perf_counter()
        got = exe.run(main, feed=beam_feed, fetch_list=names, scope=scope)
        ms = (time.perf_counter() - t0) * 1e3
        outs.append((got, ms, profiler.get_counter(
            texec.HOST_SYNC_COUNTER) - syncs0))
        del main, startup, exe, scope
    (cpu_got, cpu_ms, _s), (card_got, card_ms, syncs) = outs
    ids, scores, toks, parents, lengths = card_got
    want = np.zeros_like(toks)
    T = toks.shape[1]
    for b in range(toks.shape[0]):
        for k in range(toks.shape[2]):
            beam = k
            for t in range(T - 1, -1, -1):
                want[b, t, k] = toks[b, t, beam]
                beam = parents[b, t, beam]
    if not np.array_equal(ids, want):
        raise AssertionError("gather_tree differs from the numpy backtrack")
    same = np.array_equal(toks, cpu_got[2]) and np.array_equal(
        parents, cpu_got[3])
    first_diff = None
    score_gap = float(np.max(np.abs(np.sort(scores, -1) - np.sort(
        cpu_got[1], -1))) / max(float(np.max(np.abs(cpu_got[1]))), 1e-30))
    if not same:
        diff = np.nonzero((toks != cpu_got[2]) | (parents != cpu_got[3]))
        first_diff = int(diff[1].min())
        if score_gap > BEAM_TIE_RTOL:
            raise AssertionError(
                "beam search on the card chose apart from the CPU from step "
                "%d, final scores apart by %.3g of their size"
                % (first_diff, score_gap))
    # the loop ran until its last beam finished, or to max_step_num
    steps_run = int(lengths.max())
    beam = {"hid": BEAM_HID, "vocab": BEAM_VOCAB, "beam": BEAM_K,
            "max_steps": BEAM_STEPS, "sources": BEAM_N,
            "steps_run": steps_run, "choices_equal_cpu": bool(same),
            "first_divergence_step": first_diff,
            "final_score_rel_gap": score_gap, "tie_rtol": BEAM_TIE_RTOL,
            "backtrack_equals_numpy": True,
            "host_syncs_per_run": syncs,
            "host_syncs_per_step": syncs / max(steps_run, 1),
            "card_run_ms": card_ms, "cpu_run_ms": cpu_ms,
            "card_ms_per_step": card_ms / max(steps_run, 1)}
    return {"phase": "rnn", "ptb_lm": ptb, "imdb": imdb,
            "control_flow_rnns": cf, "beam_search": beam,
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase 21: the training runtime (DataLoader / PyReader, the file dataset
# through Executor.train_from_dataset, checkpoints, preemption and resume,
# the guardian, the supervised launcher)
# ---------------------------------------------------------------------------
TR_STEPS = 10            # the loaders, the overlap and the dataset
TR_CKPT_STEPS = 12       # the checkpoint stream of (d)
TR_CKPT_INTERVAL = 4
TR_PREEMPT_AT = 6        # run B's SIGTERM, after this step
TR_LAUNCH_STEPS = 8      # (f): the first 8 batches of (d)'s stream
TR_LAUNCH_CRASH_AT = 5   # (f)'s chaos kill, after this step
TR_OVERLAP_BAR = 1.2     # double-buffered epoch / numpy loop, at most
TR_GUARD_STEPS = 16
TR_GUARD_INTERVAL = 6    # saves after steps 5 and 11
TR_GUARD_NAN_AT = 9      # chaos NaN poison: a skip
TR_GUARD_SPIKE_AT = 13   # one constant-token batch: a grad-norm spike
TR_HEALTH_RTOL = 1e-4
TR_RESUME_RTOL = 1e-4    # only when two uninterrupted runs differ
TR_FEED_NAMES = ("ids", "pos_ids", "input_mask")
TR_MODEL = "gpt2"        # train_worker's --model: GPT-2 small's widths
TR_VOCAB = 50257


def recording_executor(place):
    """A ``fluid.Executor`` whose runs record their first fetch (the
    loss) as a float in ``.losses``, so a trainer's losses can be read
    back."""
    from paddle_tpu_torch import fluid

    class Recording(fluid.Executor):
        def run(self, *args, **kwargs):
            outs = super().run(*args, **kwargs)
            if outs:
                first = outs[0]
                self.losses.append(float(
                    first.reshape(-1)[0] if isinstance(first, torch.Tensor)
                    else np.asarray(first).reshape(-1)[0]))
            return outs

    exe = Recording(place)
    exe.losses = []
    return exe


_TR_INIT = {}   # init_fluid_params(cfg, 0), made once for every build


class TrRun(object):
    """GPT-2 small's train program at full width and depth on cuda:0,
    weights ``init_fluid_params(cfg, 0)``, a recording executor, and a
    device copy of the starting state (every persistable and the scope's
    generators) that ``reset`` puts back, so one build serves several
    runs from the same start."""

    def __init__(self, dropout, lr=TRAIN_LR):
        from paddle_tpu_torch import fluid
        from paddle_tpu_torch.models import gpt
        from paddle_tpu_torch.tools import train_worker as tw

        t = [time.perf_counter()]
        cfg = tw.config(TR_MODEL, TRAIN_T, dropout)
        with fluid.unique_name.guard():
            self.main, startup, self.feeds, self.loss = \
                gpt.build_gpt_lm_train(cfg, TRAIN_T, learning_rate=lr)
        t.append(time.perf_counter())
        self.exe = recording_executor(fluid.CUDAPlace(0))
        self.scope = fluid.Scope()
        self.exe.run(startup, scope=self.scope)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if "params" not in _TR_INIT:
            _TR_INIT["params"] = gpt.init_fluid_params(cfg, 0)
        t.append(time.perf_counter())
        gpt.load_fluid_scope(self.scope, _TR_INIT["params"])
        self.exe.losses.clear()
        self.init = (tr_state(self.main, self.scope),
                     self.scope.rng_states())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        self.build_s = dict(zip(("program", "startup", "init_params",
                                 "load"), np.diff(t).tolist()))

    def reset(self):
        state, rng = self.init
        with torch.no_grad():
            for n, t in state.items():
                self.scope.get(n).copy_(t)
        self.scope.set_rng_states(rng)
        self.exe.losses.clear()

    def close(self):
        self.main = self.exe = self.scope = self.init = None
        torch.cuda.empty_cache()


def tr_batches(n, seed):
    return [train_feed(TR_VOCAB, seed + i) for i in range(n)]


def tr_generator(batches, sleep_s=0.0):
    def gen():
        for b in batches:
            if sleep_s:
                time.sleep(sleep_s)
            yield [b[k] for k in TR_FEED_NAMES]

    return gen


def tr_state(main, scope):
    """{persistable name: a device clone of its tensor}."""
    from paddle_tpu_torch.fluid.io import is_persistable

    return {v.name: scope.get(v.name).detach().clone()
            for v in main.list_vars()
            if is_persistable(v) and isinstance(scope.get(v.name),
                                                torch.Tensor)}


def tr_compare(got, want):
    """(bit for bit equal, largest relative norm of a difference)."""
    equal = set(got) == set(want) and all(
        torch.equal(got[n], want[n]) for n in want)
    rel = 0.0
    for n in want:
        w = want[n].double()
        d = float((got[n].double() - w).norm())
        rel = max(rel, d / max(float(w.norm()), 1e-30))
    return equal, rel


def tr_rng_equal(got, want):
    return set(got) == set(want) and all(
        torch.equal(got[k][0], want[k][0])
        and torch.equal(got[k][1], want[k][1]) for k in want)


def tr_files(dirname, batches, per_file=4):
    from paddle_tpu_torch.tools import train_worker as tw

    os.makedirs(dirname, exist_ok=True)
    for i in range(0, len(batches), per_file):
        tw.write_multislot(os.path.join(dirname, "part-%05d.txt" % i),
                           batches[i: i + per_file])
    return sorted(os.path.join(dirname, f) for f in os.listdir(dirname))


def staged_pinned(batch):
    """Whether every value of a staged batch was copied from pinned
    host memory."""
    return len(batch.host) == len(TR_FEED_NAMES) and all(
        t.is_pinned() for t in batch.host.values())


def _counter(name):
    from paddle_tpu_torch.fluid import profiler

    return profiler.get_counter(name)


def tr_loaders(run, batches):
    """(a): 10 steps at dropout 0 through plain numpy feeds, then
    DataLoader, then PyReader, each from the same starting state."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import io_pipeline
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.tools import train_worker as tw

    n_layers = tw.config(TR_MODEL, TRAIN_T, 0.0).num_layers
    main, loss, exe, scope = run.main, run.loss, run.exe, run.scope

    def launches_since(before):
        return {k: n - before[k] for k, n in flash_launches().items()}

    run.reset()
    l0 = flash_launches()
    ms = []
    for b in batches:
        t0 = time.perf_counter()
        exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
    out = {"build_s": run.build_s,
           "numpy": {"losses": list(exe.losses), "step_ms": ms,
                     "launches": launches_since(l0)}}
    want = list(exe.losses)
    for kind in ("data_loader", "py_reader"):
        run.reset()
        if kind == "data_loader":
            loader = fluid.DataLoader.from_generator(
                feed_list=run.feeds, capacity=4, use_double_buffer=True)
            loader.set_batch_generator(tr_generator(batches),
                                       places=fluid.cuda_places())
            it = iter(loader)
            pull = it.__next__
        else:
            reader = fluid.PyReader(feed_list=run.feeds, capacity=4,
                                    use_double_buffer=True, iterable=False)
            reader.decorate_batch_generator(tr_generator(batches),
                                            places=fluid.cuda_places())
            reader.start()
            pull = reader.next
        h2d0 = _counter("io_pipeline_h2d_batches")
        fast0 = _counter("executor_feed_fast_lane_steps")
        waits0 = _counter("io_pipeline_stream_waits")
        l0 = flash_launches()
        pinned, staged, after_1 = [], [], None
        t0 = time.perf_counter()
        while True:
            try:
                batch = pull()
            except StopIteration:
                break
            staged.append(isinstance(batch, io_pipeline.DeviceFeedBatch)
                          and batch.device == exe.device
                          and all(batch[k].device == exe.device
                                  for k in TR_FEED_NAMES))
            pinned.append(staged_pinned(batch))
            exe.run(main, feed=batch, fetch_list=[loss], scope=scope)
            if after_1 is None:
                after_1 = (_build.builds, _counter("executor_plan_builds"))
        seconds = time.perf_counter() - t0
        if kind == "py_reader":
            reader.reset()
        launches = launches_since(l0)
        row = {"losses": list(exe.losses), "seconds": seconds,
               "h2d_batches": _counter("io_pipeline_h2d_batches") - h2d0,
               "fast_lane_steps":
                   _counter("executor_feed_fast_lane_steps") - fast0,
               "stream_waits": _counter("io_pipeline_stream_waits") - waits0,
               "all_staged_on_card": all(staged),
               "all_pinned": all(pinned), "launches": launches,
               "builds_after_step1": [_build.builds - after_1[0],
                                      _counter("executor_plan_builds")
                                      - after_1[1]]}
        out[kind] = row
        if row["losses"] != want:
            raise AssertionError("%s losses %r differ from the numpy "
                                 "loop's %r" % (kind, row["losses"], want))
        if not (row["all_staged_on_card"] and row["all_pinned"]):
            raise AssertionError("%s: a batch was not staged on the card "
                                 "from pinned memory: %r" % (kind, row))
        if not (row["h2d_batches"] == row["fast_lane_steps"]
                == row["stream_waits"] == len(batches)):
            raise AssertionError("%s: %d H2D batches, %d fast-lane steps, "
                                 "%d stream waits, expected %d each" % (
                                     kind, row["h2d_batches"],
                                     row["fast_lane_steps"],
                                     row["stream_waits"], len(batches)))
        if any(n != n_layers * len(batches) for n in launches.values()):
            raise AssertionError("%s: launches %r, expected %d a step "
                                 "each" % (kind, launches, n_layers))
        if row["builds_after_step1"] != [0, 0]:
            raise AssertionError("%s: built after step 1: %r"
                                 % (kind, row["builds_after_step1"]))
    return out, want


def tr_mixed_lod(n=TR_STEPS):
    """(a), batches that mix a LoD value with dense ones: per sequence
    the mean of a LoD feature's rows (8 sequences of 256-1024 rows of
    768) beside the mean over 1024 positions of a dense [8, 1024, 768]
    feature, an fc to 2 classes, softmax cross entropy, SGD. Through the
    double-buffered ``DataLoader`` (the LoD value keeps its host form,
    the dense ones are staged from pinned memory) and as plain feeds of
    the same values, from the same start: the losses bit for bit, one
    stream wait a batch, no fast lane."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import io_pipeline

    L = fluid.layers
    width = 768
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data(name="mx_x", shape=[-1, width], dtype="float32",
                   lod_level=1)
        d = L.data(name="mx_d", shape=[TRAIN_T, width], dtype="float32")
        label = L.data(name="mx_label", shape=[1], dtype="int64")
        feat = L.concat([L.sequence_pool(x, "average"),
                         L.reduce_mean(d, dim=[1])], axis=1)
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(feat, size=2),
                                                   label))
        fluid.optimizer.SGD(0.01).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = tr_state(main, scope)
    rs = np.random.RandomState(90)
    batches = []
    for _ in range(n):
        lens = rs.randint(TRAIN_T // 4, TRAIN_T + 1, TRAIN_BATCH).tolist()
        lod = fluid.LoDTensor(rs.rand(sum(lens), width).astype("float32"))
        lod.set_recursive_sequence_lengths([lens])
        batches.append([lod, rs.rand(TRAIN_BATCH, TRAIN_T, width)
                        .astype("float32"),
                        rs.randint(0, 2, (TRAIN_BATCH, 1)).astype("int64")])
    names = ["mx_x", "mx_d", "mx_label"]
    want = [exe.run(main, feed=dict(zip(names, b)), fetch_list=[loss],
                    scope=scope)[0].item() for b in batches]
    with torch.no_grad():
        for name, t in init.items():
            scope.get(name).copy_(t)
    loader = fluid.DataLoader.from_generator(
        feed_list=[x, d, label], capacity=4, use_double_buffer=True)
    loader.set_batch_generator(lambda: iter(batches),
                               places=fluid.cuda_places())
    c0 = {k: _counter(k) for k in ("io_pipeline_stream_waits",
                                    "executor_feed_fast_lane_steps")}
    got, mixed = [], []
    for b in loader:
        mixed.append(isinstance(b, io_pipeline.DeviceFeedBatch)
                     and b.device is None and b.event is not None
                     and isinstance(b["mx_x"], fluid.LoDTensor)
                     and all(b[k].device == exe.device
                             and b.host[k].is_pinned()
                             for k in ("mx_d", "mx_label")))
        got.append(exe.run(main, feed=b, fetch_list=[loss],
                           scope=scope)[0].item())
    counts = {k: _counter(k) - v for k, v in c0.items()}
    row = {"losses": got, "all_mixed_staged": all(mixed),
           "batches": len(got), "counters": counts}
    if got != want:
        raise AssertionError("mixed LoD batches: losses %r differ from the "
                             "plain feeds' %r" % (got, want))
    if not (len(got) == n and all(mixed)
            and counts == {"io_pipeline_stream_waits": n,
                           "executor_feed_fast_lane_steps": 0}):
        raise AssertionError("mixed LoD batches: %r" % row)
    return row


def tr_overlap(run, batches):
    """(b): a producer sleeping half a step a batch; the epoch with
    double buffering, without it, and the numpy loop over ready batches.
    The double-buffered and the numpy epochs run twice, in turns; the bar
    holds the faster of each. The producer's sleep is half the median
    step of the first numpy epoch."""
    from paddle_tpu_torch import fluid

    main, loss, exe, scope = run.main, run.loss, run.exe, run.scope
    epochs = {}

    def epoch(feeds_iter, key):
        # each step's end is a host sync (the loss fetch)
        t0 = time.perf_counter()
        ends = []
        for b in feeds_iter:
            exe.run(main, feed=b, fetch_list=[loss], scope=scope)
            ends.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        if len(ends) != len(batches):
            raise AssertionError("an epoch ran %d of %d batches"
                                 % (len(ends), len(batches)))
        epochs[key + "_step_ends_ms"] = ends
        epochs[key] = (time.perf_counter() - t0) * 1e3

    epoch(iter(batches), "numpy_ms")
    ends = epochs["numpy_ms_step_ends_ms"]
    sleep_s = float(np.median(np.diff([0.0] + ends))) / 2e3

    def loader(double):
        ld = fluid.DataLoader.from_generator(
            feed_list=run.feeds, capacity=4, use_double_buffer=double)
        ld.set_batch_generator(tr_generator(batches, sleep_s),
                               places=fluid.cuda_places())
        return iter(ld)

    # in turns, the two the bar compares twice each: a step of any epoch
    # can take a ~150 ms host hiccup, so each keeps its faster epoch
    epoch(loader(True), "double_buffer_ms")
    epoch(loader(False), "no_double_buffer_ms")
    epoch(loader(True), "double_buffer_2_ms")
    epoch(iter(batches), "numpy_2_ms")
    for key in ("numpy", "double_buffer"):
        epochs[key + "_best_ms"] = min(epochs[key + "_ms"],
                                       epochs[key + "_2_ms"])
    epochs["producer_sleep_ms"] = sleep_s * 1e3
    epochs["double_over_numpy"] = epochs["double_buffer_best_ms"] \
        / epochs["numpy_best_ms"]
    epochs["bar"] = TR_OVERLAP_BAR
    if epochs["double_over_numpy"] > TR_OVERLAP_BAR:
        raise AssertionError("double-buffered epoch %.1f ms is %.3fx the "
                             "numpy loop's %.1f ms (bar %.2f)"
                             % (epochs["double_buffer_best_ms"],
                                epochs["double_over_numpy"],
                                epochs["numpy_best_ms"], TR_OVERLAP_BAR))
    return epochs


def tr_dataset(run, tmp, batches, want):
    """(c): train_from_dataset over MultiSlot files of the same batches,
    from the same starting state."""
    from paddle_tpu_torch.fluid import native
    from paddle_tpu_torch.tools import train_worker as tw

    if not native.available():
        raise AssertionError("the native host library did not build: %s"
                             % native._compile_error)
    files = tr_files(os.path.join(tmp, "c_files"), batches, per_file=5)
    run.reset()
    h2d0 = _counter("io_pipeline_h2d_batches")
    t0 = time.perf_counter()
    steps = run.exe.train_from_dataset(
        run.main, tw.gpt_dataset(run.feeds, files, TRAIN_BATCH),
        scope=run.scope, fetch_list=[run.loss], print_period=0)
    seconds = time.perf_counter() - t0
    row = {"steps": steps, "losses": list(run.exe.losses),
           "seconds": seconds, "files": len(files), "native": True,
           "h2d_batches": _counter("io_pipeline_h2d_batches") - h2d0}
    if steps != len(batches) or row["losses"] != want or \
            row["h2d_batches"] != len(batches):
        raise AssertionError("train_from_dataset: %r, expected the numpy "
                             "loop's losses %r" % (row, want))
    return row


def _saves():
    from paddle_tpu_torch.fluid import profiler

    return {k: profiler.summarize_histogram(k) for k in (
        "ckpt_snapshot_ms", "ckpt_snapshot_bytes", "ckpt_save_ms",
        "ckpt_crc32_ms", "ckpt_fsync_ms")}


def tr_checkpoint(tmp, files):
    """(d): dropout 0.1 over a 12-step stream (``files``): run A
    uninterrupted (twice, from one build), run B with an interval save
    every 4 steps preempted by its own SIGTERM after step 6, run C
    resumed from B's checkpoints in a fresh program, scope and manager.
    Returns (line, run A's state after step 7)."""
    import signal

    from paddle_tpu_torch import checkpoint, fluid
    from paddle_tpu_torch.checkpoint import preempt as preempt_mod
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops.nn_ops import flash_dropout
    from paddle_tpu_torch.fluid.trainer import MultiTrainer
    from paddle_tpu_torch.tools import train_worker as tw

    kept = {}

    def train(run, ckpt_dir=None, on_step=None):
        mgr = checkpoint.CheckpointManager(ckpt_dir) if ckpt_dir else None
        t0 = time.perf_counter()
        steps = MultiTrainer().train(
            run.exe, run.main, tw.gpt_dataset(run.feeds, files, TRAIN_BATCH),
            scope=run.scope, fetch_list=[run.loss], print_period=0,
            on_step=on_step, ckpt_manager=mgr)
        seconds = time.perf_counter() - t0
        if mgr is not None:
            mgr.close()
        return {"steps": steps, "losses": list(run.exe.losses),
                "seconds": seconds,
                "saved_steps": mgr.all_steps() if mgr else None}

    def keep_a(step):
        if step == TR_PREEMPT_AT:
            kept["rng"] = run.scope.rng_states()
        elif step == TR_LAUNCH_STEPS - 1:
            kept["state_f"] = tr_state(run.main, run.scope)

    def preempt(step):
        if step == TR_PREEMPT_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    run = TrRun(0.1)
    run_a = train(run, on_step=keep_a)
    state_a = tr_state(run.main, run.scope)
    run.reset()
    run_a2 = train(run)
    deterministic, a2_rel = tr_compare(tr_state(run.main, run.scope),
                                       state_a)
    run.reset()
    fluid.set_flags({"ckpt_save_interval_steps": TR_CKPT_INTERVAL})
    profiler.reset_histograms()
    try:
        run_b = train(run, os.path.join(tmp, "ckpt_b"), preempt)
    finally:
        # the latch is sticky for the process: a serving phase after this
        # one must not read it as a preemption
        preempt_mod._reset_for_tests()
    build_s = run.build_s
    run.close()
    if run_b["steps"] != TR_PREEMPT_AT + 1 or \
            run_b["saved_steps"][-1] != TR_PREEMPT_AT:
        raise AssertionError("run B: %r, expected a stop after step %d "
                             "with its save" % (run_b, TR_PREEMPT_AT))
    # run C: a fresh program, scope and manager over B's directory
    run = TrRun(0.1)
    resume = {"build_s": run.build_s}
    mgr = checkpoint.CheckpointManager(os.path.join(tmp, "ckpt_b"))
    t0 = time.perf_counter()
    resume["restored_step"] = mgr.restore(run.main, scope=run.scope,
                                          executor=run.exe)
    resume["restore_s"] = time.perf_counter() - t0
    mgr.close()
    got = run.scope.rng_states()
    resume["generators_equal"] = tr_rng_equal(got, kept["rng"])
    seeds = []
    for states in (got, kept["rng"]):
        g = torch.Generator()
        g.set_state(states[str(run.exe.device)][1])
        seeds.append(flash_dropout(0.1, False, g)["dropout_seed"])
    resume["flash_seed"] = seeds[0]
    resume["flash_seed_equal"] = seeds[0] == seeds[1]
    try:
        run_c = train(run, os.path.join(tmp, "ckpt_b"))
    finally:
        fluid.set_flags({"ckpt_save_interval_steps": 0})
    c_equal, c_rel = tr_compare(tr_state(run.main, run.scope), state_a)
    run.close()
    row = {"dropout": 0.1, "steps": TR_CKPT_STEPS, "build_s": build_s,
           "interval": TR_CKPT_INTERVAL, "preempt_after": TR_PREEMPT_AT,
           "run_a": run_a, "run_a2": run_a2, "run_b": run_b,
           "run_c": run_c, "resume": resume,
           "deterministic": deterministic, "a2_vs_a_rel_norm": a2_rel,
           "c_equal_a": c_equal, "c_vs_a_rel_norm": c_rel,
           "held": "bit for bit" if deterministic else
           "relative norm %g" % TR_RESUME_RTOL,
           "saves_runs_b_c": _saves()}
    if resume["restored_step"] != TR_PREEMPT_AT:
        raise AssertionError("run C restored %r" % resume)
    if not (resume["generators_equal"] and resume["flash_seed_equal"]):
        raise AssertionError("run C's generators at step %d are not run "
                             "A's: %r" % (TR_PREEMPT_AT + 1, resume))
    if deterministic and (not c_equal or run_c["losses"]
                          != run_a["losses"][TR_PREEMPT_AT + 1:]):
        raise AssertionError("run A repeats bit for bit but run C "
                             "differs from it (rel norm %g)" % c_rel)
    if not deterministic and not c_rel <= TR_RESUME_RTOL:
        raise AssertionError("run C vs run A: relative norm %g > %g"
                             % (c_rel, TR_RESUME_RTOL))
    return row, kept["state_f"]


def tr_guardian(run, tmp):
    """(e): the armed guardian over a 16-step stream of random-token
    batches at dropout 0, saves after steps 5 and 11 scrubbed by the
    writer: a chaos NaN poison at step 9 (a skip), one batch of a single
    repeated token at step 13 (its gradient norm jumps: a rollback to the
    newest verified checkpoint), then the health fetch against the
    gradients of one more step."""
    from paddle_tpu_torch import checkpoint, fluid
    from paddle_tpu_torch.distributed import guardian as gmod
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.trainer import MultiTrainer
    from paddle_tpu_torch.tools import train_worker as tw

    batches = tr_batches(TR_GUARD_STEPS, 80)
    spike = batches[TR_GUARD_SPIKE_AT]
    spike["ids"] = np.full_like(spike["ids"], 7)
    spike["input_mask"] = np.ones_like(spike["input_mask"])
    files = tr_files(os.path.join(tmp, "e_files"), batches)
    flags = {"guardian_enable": True, "guardian_warmup_steps": 6,
             "guardian_max_skips": 1, "guardian_max_rollbacks": 1,
             "guardian_marker_dir": os.path.join(tmp, "e_markers"),
             "ckpt_save_interval_steps": TR_GUARD_INTERVAL,
             "ckpt_scrub": True,
             "chaos_nan_grad_at_step": TR_GUARD_NAN_AT,
             "chaos_marker_dir": os.path.join(tmp, "e_chaos")}
    defaults = fluid.get_flags(list(flags))
    main, scope, exe = run.main, run.scope, run.exe
    run.reset()
    fluid.set_flags(flags)
    mgr = checkpoint.CheckpointManager(os.path.join(tmp, "ckpt_e"))
    seen = {}

    def on_step(step):
        if step == TR_GUARD_NAN_AT - 1:
            seen["pre"] = (tr_state(main, scope), scope.rng_states())
        elif step == TR_GUARD_NAN_AT and "pre" in seen:
            pre_state, pre_rng = seen.pop("pre")
            seen["skip_restored"] = tr_compare(tr_state(main, scope),
                                               pre_state)[0]
            seen["skip_generators"] = tr_rng_equal(scope.rng_states(),
                                                   pre_rng)

    profiler.reset_histograms()
    c0 = {k: _counter(k) for k in ("train_skipped_steps", "train_rollbacks",
                                    "train_anomalies")}
    t0 = time.perf_counter()
    try:
        steps = MultiTrainer().train(
            exe, main, tw.gpt_dataset(run.feeds, files, TRAIN_BATCH),
            scope=scope, fetch_list=[run.loss], print_period=0,
            on_step=on_step, ckpt_manager=mgr)
    finally:
        fluid.set_flags({k[len("FLAGS_"):]: v for k, v in defaults.items()})
        mgr.close()
    seconds = time.perf_counter() - t0
    counts = {k: _counter(k) - v for k, v in c0.items()}
    rollback = profiler.summarize_histogram("guardian_rollback_ms")
    losses = list(exe.losses)
    # the health fetch against the gradients of one more step
    partials = gmod.attach_health_fetch(main)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    outs = exe.run(main, feed=batches[0], scope=scope,
                   fetch_list=[run.loss] + partials + grads,
                   return_numpy=False)
    health = float(sum(o.double().sum() for o in outs[1: 1 + len(partials)]))
    sq = float(sum((g.double() ** 2).sum() for g in outs[1 + len(partials):]))
    health_rel = abs(health - sq) / sq
    del outs
    row = {"steps": steps, "losses": losses, "seconds": seconds,
           "counters": counts, "rollback_ms": rollback,
           "skip_restored_bit_for_bit": seen.get("skip_restored"),
           "skip_generators_restored": seen.get("skip_generators"),
           "nan_at": TR_GUARD_NAN_AT, "spike_at": TR_GUARD_SPIKE_AT,
           "saved_steps": mgr.all_steps(), "saves": _saves(),
           "health_sum_sq": health, "grads_sum_sq": sq,
           "health_rel": health_rel, "health_params": len(grads)}
    if counts != {"train_skipped_steps": 1, "train_rollbacks": 1,
                  "train_anomalies": 2}:
        raise AssertionError("guardian ladder: %r, expected one skip and "
                             "one rollback" % counts)
    if not (row["skip_restored_bit_for_bit"]
            and row["skip_generators_restored"]):
        raise AssertionError("the skip did not restore the pre-step state "
                             "bit for bit: %r" % row)
    if steps != TR_GUARD_STEPS or not np.all(np.isfinite(losses[-3:])):
        raise AssertionError("after the rollback: steps %d, losses %r"
                             % (steps, losses))
    if not health_rel <= TR_HEALTH_RTOL:
        raise AssertionError("health fetch %.9g vs sum of squared grads "
                             "%.9g: rel %.3g > %g" % (health, sq, health_rel,
                                                      TR_HEALTH_RTOL))
    return row


def tr_launch(tmp, files):
    """(f): one worker under ``python -m
    paddle_tpu_torch.distributed.launch --max_restarts 1`` on cuda:0
    over the first 8 batches of (d)'s stream (``files``), its interval
    saves committed before its next step (``--sync_saves``), killed by
    the chaos hook (``chaos_crash_at_step``, once) after step
    ``TR_LAUNCH_CRASH_AT`` while it still trains, restarted by the
    supervisor, resumed from its newest checkpoint. Returns (line, its
    checkpoint dir)."""
    import re

    from paddle_tpu_torch.distributed import supervisor

    root = os.path.dirname(os.path.abspath(__file__))
    sup_dir = os.path.join(tmp, "f_supervisor")
    out_dir = os.path.join(tmp, "f_out")
    ck = os.path.join(tmp, "f_ckpt", "rank_0")
    f_dir = os.path.join(tmp, "f_files")
    os.makedirs(f_dir)
    for path in files[:TR_LAUNCH_STEPS // TR_CKPT_INTERVAL]:
        shutil.copy(path, f_dir)
    hb_path = os.path.join(sup_dir, "heartbeats", "heartbeat_0.json")
    env = dict(os.environ, PYTHONPATH=root,
               FLAGS_chaos_crash_at_step=str(TR_LAUNCH_CRASH_AT),
               FLAGS_chaos_marker_dir=os.path.join(tmp, "f_chaos"))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--max_restarts", "1", "--selected_gpus", "0",
           "--supervisor_dir", sup_dir,
           os.path.join(root, "paddle_tpu_torch", "tools",
                        "train_worker.py"),
           "--files", f_dir, "--ckpt", os.path.dirname(ck),
           "--out", out_dir, "--model", TR_MODEL, "--seq", str(TRAIN_T),
           "--batch", str(TRAIN_BATCH), "--interval", str(TR_CKPT_INTERVAL),
           "--sync_saves"]
    log_path = os.path.join(tmp, "f_launch.log")
    t0 = time.perf_counter()
    beats = {}   # pid: the last heartbeat seen from it
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("launch ran past 600 s")
                hb = supervisor.read_heartbeat(hb_path)
                if hb:
                    beats[int(hb["pid"])] = hb
                time.sleep(0.02)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        log_text = f.read()
    crash = re.findall(r"CHAOS crash_at_step=(\d+) pid=(\d+)", log_text)
    if proc.returncode != 0 or len(crash) != 1:
        raise AssertionError("launch exited %d, chaos crashes %r: %s" % (
            proc.returncode, crash, log_text[-3000:]))
    killed = {"step": int(crash[0][0]), "pid": int(crash[0][1]),
              "last_heartbeat": beats.get(int(crash[0][1]))}
    events = supervisor.load_events(sup_dir)
    kinds = [e["event"] for e in events]
    with open(os.path.join(out_dir, "rank_0.json")) as f:
        worker = json.load(f)
    hb = supervisor.read_heartbeat(hb_path)
    mono = {}
    for e in events:
        mono.setdefault((e["event"], e.get("restart")), e["ts_mono"])
    crashed = [t for (k, _r), t in mono.items() if k == "crash_detected"]
    row = {"seconds": seconds, "events": kinds, "worker": worker,
           "heartbeat": hb, "killed": killed, "steps": TR_LAUNCH_STEPS,
           "crash_to_restart_s": mono[("gang_start", 1)] - crashed[0]
           if crashed and ("gang_start", 1) in mono else None,
           "restart_to_done_s": mono[("gang_done", 1)]
           - mono[("gang_start", 1)] if ("gang_done", 1) in mono
           and ("gang_start", 1) in mono else None}
    for want in ("crash_detected", "restart", "gang_done"):
        if want not in kinds:
            raise AssertionError("supervisor log lacks %s: %r"
                                 % (want, kinds))
    last = killed["last_heartbeat"]
    if not last or last.get("status") == "done" or \
            not last.get("step", TR_LAUNCH_STEPS) < TR_LAUNCH_STEPS - 1:
        raise AssertionError("the chaos kill did not land mid-run: the "
                             "killed worker's last heartbeat %r" % last)
    if not hb or hb.get("status") != "done" or \
            hb.get("step") != TR_LAUNCH_STEPS - 1:
        raise AssertionError("the worker's last heartbeat: %r" % hb)
    want_restored = (TR_LAUNCH_CRASH_AT + 1) // TR_CKPT_INTERVAL \
        * TR_CKPT_INTERVAL - 1
    if (worker["restored"] or {}).get("step") != want_restored or \
            worker["steps"] != TR_LAUNCH_STEPS:
        raise AssertionError("the restarted worker did not resume from "
                             "step %d: %r" % (want_restored, worker))
    return row, ck


def tr_final_state(ck, like):
    """The newest checkpoint under ``ck``, on ``like``'s device, for
    ``like``'s names."""
    from paddle_tpu_torch import checkpoint

    mgr = checkpoint.CheckpointManager(ck)
    dev = next(iter(like.values())).device
    final = {n: v.to(dev) for n, v in mgr._iter_step_tensors(
        mgr.latest_step()) if n in like}
    mgr.close()
    return final


def train_runtime_phase(dev):
    """The training runtime on GPT-2 small at 8 x 1024, fp32: (a) the
    loaders against numpy feeds, (b) the overlap, (c) the file dataset,
    (d) checkpoints, preemption and resume, (e) the guardian, (f) the
    supervised launcher, beside (a), (c) and (e); (d), then (b), after
    it, alone. Returns (line, the three kernels' launches in this
    process's (a)-(e))."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="train_runtime_")
    parts = {}

    def part(name, fn, *args):
        # each part's seconds on stderr as it ends (stdout keeps the
        # phase's one line)
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        print(json.dumps({"train_runtime_part": name,
                          "seconds": parts[name]}),
              file=sys.stderr, flush=True)
        return out

    run0 = None
    launch = {}
    launcher_thread = None
    try:
        zero_flash_launches()
        files = tr_files(os.path.join(tmp, "d_files"),
                         tr_batches(TR_CKPT_STEPS, 60))

        # (f) runs in its own processes beside (a), (c) and (e), whose
        # checks are bit for bit and whose times then include its load;
        # (d), whose saves and resume are timed, and (b), the one timing
        # bar, run after it, alone
        def launch_f():
            try:
                launch["row"] = tr_launch(tmp, files)
            except BaseException as exc:  # re-raised below
                launch["error"] = exc

        launcher_thread = threading.Thread(target=launch_f, daemon=True)
        launcher_thread.start()
        batches = tr_batches(TR_STEPS, 40)
        run0 = part("build", TrRun, 0.0)
        loaders, want = part("loaders", tr_loaders, run0, batches)
        loaders["mixed_lod"] = part("mixed_lod", tr_mixed_lod)
        dataset = part("dataset", tr_dataset, run0, tmp, batches, want)
        guard = part("guardian", tr_guardian, run0, tmp)
        run0.close()
        t0 = time.perf_counter()
        launcher_thread.join(900)
        parts["launcher_wait"] = time.perf_counter() - t0
        if "row" not in launch:
            raise launch.get("error") or AssertionError(
                "the launcher part did not end in 900 s")
        launcher, ck = launch["row"]
        ckpt, state_f = part("checkpoint", tr_checkpoint, tmp, files)
        # a fresh build: (e) appended the health fetch to run0's program
        run0 = TrRun(0.0)
        overlap = part("overlap", tr_overlap, run0, batches)
        run0.close()
        launches = flash_launches()
        equal, rel = tr_compare(tr_final_state(ck, state_f), state_f)
        launcher.update(final_equal_run_a=equal,
                        final_vs_run_a_rel_norm=rel)
        del state_f
        torch.cuda.empty_cache()
        if ckpt["deterministic"] and not equal:
            raise AssertionError("the launched worker's final state "
                                 "differs from run A (rel %g)" % rel)
        if not ckpt["deterministic"] and not rel <= TR_RESUME_RTOL:
            raise AssertionError("the launched worker's final state vs "
                                 "run A: rel %g > %g" % (rel,
                                                         TR_RESUME_RTOL))
    finally:
        if run0 is not None:
            run0.close()
        if launcher_thread is not None:
            launcher_thread.join(900)
        shutil.rmtree(tmp, ignore_errors=True)
        _TR_INIT.clear()
    return {"phase": "train_runtime", "model": "gpt2-small",
            "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
            "loaders": loaders, "overlap": overlap, "dataset": dataset,
            "checkpoint": ckpt, "guardian": guard, "launcher": launcher,
            "launches": launches, "parts_s": parts,
            "seconds": time.perf_counter() - t_phase}, launches


# ---------------------------------------------------------------------------
# dp: data-parallel training over torch.distributed (one launch, 2 ranks)
# ---------------------------------------------------------------------------
# Two ranks of ``python -m paddle_tpu_torch.distributed.launch
# --nproc_per_node 2`` share card 0 over gloo (NCCL refuses two ranks on
# one GPU), each running this script's hidden ``--dp-worker`` mode: (a)
# every c_* op, (b) ResNet-50 (config 4), (c) GPT-2 small, (d) a one-rank
# NCCL group, in that order, in the same processes.
DP_RANKS = 2
DP_TIMEOUT_S = 600               # the whole launch; the launcher is killed
DP_COLLECTIVE_TIMEOUT_S = 180    # the rendezvous and each collective
DP_SPEC = {"device": "cuda",
           "resnet": {"depth": 50, "classes": 1000, "size": 224,
                      "batch": 32, "steps": 3},
           "gpt": "gpt2", "gpt_batch": 8, "gpt_t": 1024, "gpt_steps": 2,
           "nccl": True, "parts": ["ops", "resnet", "gpt", "nccl", "dygraph"],
           "lenet_batch": 64, "lenet_steps": 3, "lenet_lr": 0.05}
# c_* ops against numpy on fp32 values in [0.5, 1.5): sums of 2 terms
# and products of 2 factors, exact to an ulp or two.
DP_OP_ATOL = 1e-5
# sync_batch_norm against batch_norm on the joined batch (the same
# arithmetic, the statistics summed in another order): ~1e-6 observed
# class; a wrong group or scale moves Y by O(0.1).
DP_BN_ATOL = 1e-4
# ResNet-50 per rank against the hand computation (the plain program's
# gradients on each half, their mean, the momentum update), both with
# cuDNN's deterministic algorithms: the same kernels on the same halves,
# the 1/2 loss-gradient scale exact, so the two agree to the gradient
# sum's rounding. (With cuDNN's atomic weight gradients, lr 0.1 and
# momentum 0.9 amplify run-to-run ulps to 0.4% of the loss by step 3 on
# an NVIDIA H100 80GB HBM3 at 700 W.) The timed steps after them run
# cuDNN's default algorithms.
DP_RESNET_LOSS_RTOL = 1e-5
DP_RESNET_PARAM_RTOL = 1e-5      # relative to the parameters' own norm
DP_RESNET_TIMED_STEPS = 3
# GPT-2 small, 2 ranks of 4 x 1024 against one process on 8 x 1024:
# the loss to 1e-5 relative; the parameters' change over the steps to
# 1e-3 relative norm (Adam divides each element by its own gradient's
# size, so an element whose gradient is near 0 moves by an ulp-sized
# difference scaled up).
DP_GPT_LOSS_RTOL = 1e-5
DP_GPT_UPDATE_RTOL = 1e-3
DP_QUANT_STEPS = 4               # the quantized bound: 4 steps of absmax/127
DP_NCCL_RING = 7


def _dp_err(a, b):
    """Max |a - b| of two tensors or arrays, in fp64 on the host."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().double().cpu()
        return torch.as_tensor(np.asarray(v, np.float64))

    return float((host(a) - host(b)).abs().max())


def _dp_place(dev):
    from paddle_tpu_torch import fluid

    return fluid.CUDAPlace(0) if dev.type == "cuda" else fluid.CPUPlace()


def _dp_shard(a, rank, world):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


DP_OPS = (("c_allreduce_sum", {}), ("c_allreduce_max", {}),
          ("c_allreduce_min", {}), ("c_allreduce_prod", {}),
          ("allreduce", {}), ("c_broadcast", {"root": 1}),
          ("broadcast", {"root": 0}), ("c_allgather", {"nranks": 2}),
          ("c_reducescatter", {"nranks": 2}))


def _dp_op_program(op_type, attrs, ring_id=0):
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[64], dtype="float32")
        x.stop_gradient = False
        cw = fluid.layers.data(name="cw", shape=[64], dtype="float32")
        helper = fluid.layer_helper.LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]},
                         attrs=dict(attrs, ring_id=ring_id))
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out, cw))
        gx = fluid.gradients(loss, x)[0]
    return main, startup, out, gx


def _dp_op_oracle(op_type, attrs, xs, cws, rank):
    """Rank ``rank``'s (out, grad of x) for the data-parallel program
    (loss gradient scaled by 1/n): xs [n, rows, 64], cws [n, out rows,
    64]."""
    n = xs.shape[0]
    c = cws.sum(0) / n
    if op_type in ("c_allreduce_sum", "allreduce"):
        return xs.sum(0), c
    if op_type in ("c_allreduce_max", "c_allreduce_min"):
        ext = xs.max(0) if op_type.endswith("max") else xs.min(0)
        hit = (xs == ext).astype(np.float32)
        return ext, c * hit[rank] / hit.sum(0)
    if op_type == "c_allreduce_prod":
        return xs.prod(0), c * np.prod(np.delete(xs, rank, 0), axis=0)
    if op_type == "c_allgather":
        rows = xs.shape[1]
        return xs.reshape(-1, xs.shape[2]), c[rank * rows:(rank + 1) * rows]
    if op_type == "c_reducescatter":
        rows = xs.shape[1] // n
        return (xs.sum(0)[rank * rows:(rank + 1) * rows],
                (cws / n).reshape(-1, cws.shape[2]))
    root = attrs["root"]
    return xs[root], c if rank == root else np.zeros_like(c)


def dp_ops(rank, world, dev):
    """(a): every c_* op and its gradient on this device's tensors, each
    rank's shard through ``with_data_parallel``, against numpy; the
    stream syncs and bootstrap ops; the quantized sum against its bound
    (through the op under the flag too); ``sync_batch_norm`` against
    ``batch_norm`` on the joined batch."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import flags
    from paddle_tpu_torch.fluid.ops import nn_ops
    from paddle_tpu_torch.parallel import quantized_allreduce as qar

    place = _dp_place(dev)
    exe = fluid.Executor(place)
    errs = {}

    def run_dp(main, startup, feed, fetch):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        comp = fluid.CompiledProgram(main).with_data_parallel()
        return exe.run(comp, feed=feed, fetch_list=fetch, scope=scope)

    rng = np.random.default_rng(5)
    for op_type, attrs in DP_OPS:
        rows = 4
        out_rows = {"c_allgather": world * rows,
                    "c_reducescatter": rows // world}.get(op_type, rows)
        xs = rng.uniform(0.5, 1.5, (world, rows, 64)).astype(np.float32)
        cws = rng.standard_normal((world, out_rows, 64)).astype(np.float32)
        main, startup, out, gx = _dp_op_program(op_type, attrs)
        o, g = run_dp(main, startup, {"x": xs[rank], "cw": cws[rank]},
                      [out, gx])
        wo, wg = _dp_op_oracle(op_type, attrs, xs, cws, rank)
        errs[op_type] = [_dp_err(o, wo), _dp_err(g, wg)]
    # the stream syncs and the bootstrap ops
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=[64], dtype="float32")
        helper = fluid.layer_helper.LayerHelper("sync")
        a = helper.create_variable_for_type_inference(dtype="float32")
        b = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type="c_sync_calc_stream", inputs={"X": [xv]},
                         outputs={"Out": [a]})
        helper.append_op(type="c_sync_comm_stream", inputs={"X": [a]},
                         outputs={"Out": [b]})
        sb = startup.global_block()
        for t in ("c_gen_nccl_id", "gen_nccl_id", "c_comm_init_all"):
            sb.append_op(type=t, inputs={}, outputs={}, attrs={})
        sb.append_op(type="c_comm_init", inputs={}, outputs={},
                     attrs={"ring_id": 1, "nranks": world, "rank": rank})
    xv = rng.uniform(0.5, 1.5, (4, 64)).astype(np.float32)
    (bv,) = run_dp(main, startup, {"x": xv}, [b])
    errs["c_sync_calc_stream+c_sync_comm_stream"] = [_dp_err(bv, xv), 0.0]
    # the quantized sum: each element within DP_QUANT_STEPS steps of the
    # joined absmax / 127, and straight through in the backward
    xq = rng.standard_normal((world, 1 << 20)).astype(np.float32)
    t = torch.tensor(xq[rank], device=dev, requires_grad=True)
    s = qar.quantized_psum(t)
    (s * s).sum().backward()
    bound = DP_QUANT_STEPS * np.abs(xq).max() * world / 127.0
    # d/dt of every rank's sum(s^2) through the straight-through sum
    quant = {"max_abs_err": _dp_err(s, xq.sum(0)), "bound": bound,
             "grad_err": _dp_err(t.grad, 2 * world * s.detach())}
    flags.set_flags({"quantized_allreduce": True})
    try:
        xs = rng.uniform(0.5, 1.5, (world, 4, 64)).astype(np.float32)
        cws = rng.standard_normal((world, 4, 64)).astype(np.float32)
        main, startup, out, gx = _dp_op_program("c_allreduce_sum", {})
        o, g = run_dp(main, startup, {"x": xs[rank], "cw": cws[rank]},
                      [out, gx])
    finally:
        flags.set_flags({"quantized_allreduce": False})
    wo, wg = _dp_op_oracle("c_allreduce_sum", {}, xs, cws, rank)
    quant["op_err"] = _dp_err(o, wo)
    quant["op_bound"] = DP_QUANT_STEPS * np.abs(xs).max() * world / 127.0
    quant["op_grad_err"] = _dp_err(g, wg)
    # sync_batch_norm vs batch_norm on the joined batch (forward, and the
    # gradients of sum(Y * cw) with the rewrite's 1/n)
    shape = (world * 4, 16, 8, 8)
    xb = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    cwb = rng.standard_normal(shape).astype(np.float32)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=list(shape[1:]),
                              dtype="float32")
        x.stop_gradient = False
        cw = fluid.layers.data(name="cw", shape=list(shape[1:]),
                               dtype="float32")
        y = fluid.layers.batch_norm(input=x)
        for op_ in main.global_block().ops:
            if op_.type == "batch_norm":
                op_.type = "sync_batch_norm"
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(y, cw))
        gx = fluid.gradients(loss, x)[0]
    yv, gv, gs = run_dp(main, startup, {"x": _dp_shard(xb, rank, world),
                                        "cw": _dp_shard(cwb, rank, world)},
                        [y, gx, "batch_norm_0.w_0@GRAD"])
    xj = torch.tensor(xb, device=dev, requires_grad=True)
    sc = torch.ones(16, device=dev, requires_grad=True)
    yj = nn_ops.batch_norm(xj, sc, torch.zeros(16, device=dev),
                           torch.zeros(16, device=dev),
                           torch.ones(16, device=dev))[0]
    (yj * torch.tensor(cwb, device=dev)).sum().div(world).backward()
    bn = {"y_err": _dp_err(yv, _dp_shard(yj.detach(), rank, world)),
          "dx_err": _dp_err(gv, _dp_shard(xj.grad, rank, world)),
          "dscale_err": _dp_err(gs, sc.grad)}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"errs": errs, "quantized": quant, "sync_batch_norm": bn}


class _CollectiveClock(object):
    """Wall time inside ``torch.distributed.all_reduce`` (the device
    drained first, so a call's own time is what is counted) and its
    calls, while armed."""

    def __init__(self, dev):
        import torch.distributed as dist

        self.dev, self.dist = dev, dist
        self.ms, self.calls, self._orig = 0.0, 0, dist.all_reduce

    def __enter__(self):
        orig = self._orig

        def timed(*a, **k):
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = orig(*a, **k)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            return r

        self.dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self._orig


class _cudnn_deterministic(object):
    """cuDNN's deterministic algorithms on (or off) inside."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = self.on

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.was


def _dp_rank_spread(tensors):
    """Max |rank 0's value − this rank's| over ``tensors`` (rank 0's come
    over a broadcast), 0 on rank 0."""
    import torch.distributed as dist

    worst = 0.0
    for t in tensors:
        ref = t.detach().clone().contiguous()
        dist.broadcast(ref, src=0)
        worst = max(worst, float((ref - t).abs().max()))
    return worst


def _dp_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _dp_gather(values, dev):
    """Every rank's float list, on every rank: [rank][i]."""
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=dev)
    got = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(got, t)
    return [g.tolist() for g in got]


def _dp_rel_norm(got, want, base=None):
    """||got - want|| / ||want - base|| (||want|| without base), summed
    over the names of ``want``."""
    num = den = 0.0
    for n, w in want.items():
        num += float((got[n].double() - w.double()).norm()) ** 2
        ref = w.double() if base is None else w.double() - base[n].double()
        den += float(ref.norm()) ** 2
    return (num / max(den, 1e-300)) ** 0.5


def dp_resnet(rank, world, dev, rs):
    """(b) BASELINE.json config 4: ``build_resnet_train(depth)`` through
    ``CompiledProgram.with_data_parallel``, ``batch`` images a rank, fp32,
    each rank's batch norm over its own images. Then rank 0 computes the
    same steps by hand: the plain program's gradients on each rank's
    half (in a scope of that half, so its running stats move as that
    rank's), their mean, the momentum update."""
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet

    place = _dp_place(dev)
    exe = fluid.Executor(place)

    def build():
        with fluid.unique_name.guard():
            main, startup, _f, loss, _acc = resnet.build_resnet_train(
                rs["depth"], rs["classes"], rs["size"])
        main.random_seed = startup.random_seed = 17
        return main, startup, loss

    def fresh_scope(startup):
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        return scope

    feeds = [image_feed(world * rs["batch"], 3, rs["size"], rs["classes"],
                        100 + s) for s in range(rs["steps"])]
    main, startup, loss = build()
    scope = fresh_scope(startup)
    names = sorted(p for p, _g in main._params_grads)   # the trainable
    stats = sorted(v.name for v in main.list_vars() if v.persistable
                   and v.name.startswith("batch_norm")
                   and v.name.endswith((".w_1", ".w_2")))
    # the ranks start equal: one seeded startup on each
    start_spread = _dp_rank_spread([scope.get(n) for n in names + stats])
    init = {n: scope.get(n).detach().clone() for n in names + stats}
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)

    def steps(first, n):
        losses, step_ms, coll_ms, coll_calls = [], [], [], []
        for s in range(first, first + n):
            feed = {k: _dp_shard(v, rank, world)
                    for k, v in feeds[s % len(feeds)].items()}
            _dp_sync(dev)
            with _CollectiveClock(dev) as clock:
                t0 = time.perf_counter()
                (lv,) = exe.run(compiled, feed=feed, fetch_list=[loss],
                                scope=scope)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lv.reshape(-1)[0]))
            coll_ms.append(clock.ms)
            coll_calls.append(clock.calls)
        return losses, step_ms, coll_ms, coll_calls

    with _cudnn_deterministic(True):
        losses, checked_ms, _c, _n = steps(0, rs["steps"])
    out = {"losses": losses, "checked_step_ms": checked_ms,
           "c_allreduce_sum_ops": sum(o.type == "c_allreduce_sum"
                                      for o in main.global_block().ops),
           "params": len(names), "start_spread": start_spread,
           "rank_spread": _dp_rank_spread([scope.get(n) for n in names])}
    rank_losses = _dp_gather(losses, dev)
    rank_stats = {}
    for n in stats:
        t = scope.get(n).detach().contiguous()
        got = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(got, t)
        rank_stats[n] = got
    dp_params = {n: scope.get(n).detach().clone() for n in names}
    # timed steps, cuDNN's default algorithms
    with _cudnn_deterministic(False):
        (out["timed_losses"], out["step_ms"], out["collective_ms"],
         out["collective_calls"]) = steps(rs["steps"], DP_RESNET_TIMED_STEPS)
    del compiled, scope
    if rank == 0:
        with _cudnn_deterministic(True):
            out.update(_dp_resnet_by_hand(
                build, fresh_scope, exe, init, names, stats, feeds, world,
                rs, rank_losses, rank_stats, dp_params))
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _dp_resnet_by_hand(build, fresh_scope, exe, init, names, stats, feeds,
                       world, rs, rank_losses, rank_stats, dp_params):
    """Rank 0's computation of the ranks' steps by hand, and how far the
    ranks' losses, parameters and running stats are from it."""
    from paddle_tpu_torch.fluid.ops import optimizer_ops

    hmain, hstartup, hloss = build()
    scopes = [fresh_scope(hstartup) for _ in range(world)]
    for sc in scopes:
        for n in stats:
            sc.get(n).copy_(init[n])
    mom = next(o for o in hmain.global_block().ops if o.type == "momentum")
    mu = float(mom.attr("mu"))
    lr = scopes[0].get(mom.input("LearningRate")[0])
    p = {n: init[n].clone() for n in names}
    vel = {n: torch.zeros_like(v) for n, v in p.items()}
    hand = [[] for _ in range(world)]
    for s in range(rs["steps"]):
        total = None
        for r, sc in enumerate(scopes):
            for n in names:
                sc.get(n).copy_(p[n])
            outs = exe.run(hmain, feed={k: _dp_shard(v, r, world)
                                        for k, v in feeds[s].items()},
                           fetch_list=[hloss] + [n + "@GRAD" for n in names],
                           scope=sc, return_numpy=False)
            hand[r].append(float(outs[0].reshape(-1)[0]))
            total = outs[1:] if total is None else [
                a + b for a, b in zip(total, outs[1:])]
        for n, g in zip(names, total):
            optimizer_ops.momentum(p[n], g / world, vel[n], lr, mu)
    return {"hand_losses": hand,
            "loss_rel": max(abs(a - b) / abs(b) for r in range(world)
                            for a, b in zip(rank_losses[r], hand[r])),
            "param_rel": _dp_rel_norm(dp_params, p),
            "param_max_abs_err": max(_dp_err(dp_params[n], p[n])
                                     for n in names),
            "stat_max_err": max(_dp_err(rank_stats[n][r], scopes[r].get(n))
                                for n in stats for r in range(world))}


def dp_gpt(rank, world, dev, spec):
    """(c) GPT-2 small at full width through the flash kernels: each rank
    on its ``gpt_batch / world`` rows of ``gpt_t`` tokens (no padding, so
    every rank's loss weighs as many tokens), Adam, dropout 0; then rank
    0 runs one process on the whole batch from the same weights. Flash
    launches are zeroed just before the data-parallel steps and read just
    after."""
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import gpt

    place = _dp_place(dev)
    T, B = spec["gpt_t"], spec["gpt_batch"]
    kw = dict(use_flash_attention=True, hidden_dropout=0.0,
              attention_dropout=0.0)
    cfg = gpt.GPTConfig(**kw) if spec["gpt"] == "gpt2" else \
        gpt.GPTConfig.tiny(max_position_embeddings=T, **kw)
    arrays = gpt.init_fluid_params(cfg, 0)
    rng = np.random.default_rng(21)
    feeds = [{"ids": rng.integers(0, cfg.vocab_size, (B, T, 1)),
              "pos_ids": np.tile(np.arange(T).reshape(1, T, 1), (B, 1, 1)),
              "input_mask": np.ones((B, T, 1), np.float32)}
             for _ in range(spec["gpt_steps"])]

    def build():
        with fluid.unique_name.guard():
            main, startup, _f, loss = gpt.build_gpt_lm_train(
                cfg, T, learning_rate=TRAIN_LR)
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        gpt.load_fluid_scope(scope, arrays)
        return main, loss, exe, scope

    main, loss, exe, scope = build()
    names = sorted(p for p, _g in main._params_grads)
    start_spread = _dp_rank_spread([scope.get(n) for n in names])
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    losses, step_ms, coll_ms = [], [], []
    zero_flash_launches()
    for s in range(spec["gpt_steps"]):
        feed = {k: _dp_shard(v, rank, world) for k, v in feeds[s].items()}
        _dp_sync(dev)
        with _CollectiveClock(dev) as clock:
            t0 = time.perf_counter()
            (lv,) = exe.run(compiled, feed=feed, fetch_list=[loss],
                            scope=scope)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv.reshape(-1)[0]))
        coll_ms.append(clock.ms)
    launches = flash_launches()
    out = {"losses": losses, "step_ms": step_ms, "collective_ms": coll_ms,
           "launches": launches, "start_spread": start_spread,
           "rank_spread": _dp_rank_spread([scope.get(n) for n in names]),
           "params": len(names)}
    rank_losses = _dp_gather(losses, dev)
    dp_params = {n: scope.get(n).detach().clone() for n in names}
    del compiled, scope, exe
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        smain, sloss, sexe, sscope = build()
        single = [float(sexe.run(smain, feed=f, fetch_list=[sloss],
                                 scope=sscope)[0].reshape(-1)[0])
                  for f in feeds]
        joined = np.mean(rank_losses, axis=0)
        base = {n: torch.as_tensor(arrays[n], device=dev) for n in names}
        out.update(
            single_losses=single, joined_losses=joined.tolist(),
            loss_rel=float(np.max(np.abs(joined - single) / np.abs(single))),
            update_rel=_dp_rel_norm(
                dp_params, {n: sscope.get(n) for n in names}, base))
        del sscope, base
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def dp_nccl(rank, world, dev):
    """(d) a one-rank NCCL group (rank 0) registered as ring
    ``DP_NCCL_RING``: c_allreduce_sum, c_broadcast and c_allgather on the
    card through it (one rank: each is the identity, its gradient the
    cotangent)."""
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.parallel import CommContext

    group = dist.new_group([0], backend="nccl")
    out = {}
    if rank == 0:
        CommContext.instance().register(DP_NCCL_RING, group)
        exe = fluid.Executor(_dp_place(dev))
        rng = np.random.default_rng(9)
        errs = {}
        for op_type, attrs in (("c_allreduce_sum", {}),
                               ("c_broadcast", {"root": 0}),
                               ("c_allgather", {"nranks": 1})):
            main, startup, o, gx = _dp_op_program(op_type, attrs,
                                                  ring_id=DP_NCCL_RING)
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            x = rng.standard_normal((4, 64)).astype(np.float32)
            cw = rng.standard_normal((4, 64)).astype(np.float32)
            ov, gv = exe.run(main, feed={"x": x, "cw": cw},
                             fetch_list=[o, gx], scope=scope)
            errs[op_type] = [_dp_err(ov, x), _dp_err(gv, cw)]
        out = {"backend": str(dist.get_backend(group)), "errs": errs}
    dist.barrier()
    return out


def dp_worker_main(argv):
    """The hidden ``--dp-worker OUT_DIR SPEC_JSON`` mode: one rank of the
    dp phase, started by the port's launcher; joins the world over gloo
    (``env://``), runs (a)-(d) and writes ``OUT_DIR/dp_rank<r>.json``.
    A check that misses raises, so the rank exits non-zero and the
    launcher tears the gang down."""
    from paddle_tpu_torch import parallel

    out_dir, spec = argv[0], json.loads(argv[1])
    parallel.initialize_distributed(backend="gloo",
                                    timeout_s=DP_COLLECTIVE_TIMEOUT_S)
    rank, world = parallel.rank(), parallel.world_size()
    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = {"rank": rank, "world": world, "seconds": {}}
    parts = {"ops": lambda: dp_ops(rank, world, dev),
             "resnet": lambda: dp_resnet(rank, world, dev, spec["resnet"]),
             "gpt": lambda: dp_gpt(rank, world, dev, spec),
             "nccl": lambda: dp_nccl(rank, world, dev)
             if spec["nccl"] else {},
             "dygraph": lambda: dyg_dp_lenet(rank, world, dev, spec)}
    for part in spec["parts"]:
        fn = parts[part]
        t0 = time.perf_counter()
        res[part] = fn()
        res["seconds"][part] = time.perf_counter() - t0
        if dev.type == "cuda":
            res.setdefault("peak_bytes", {})[part] = \
                torch.cuda.max_memory_allocated()
        print("dp rank %d: %s %.1f s" % (rank, part, res["seconds"][part]),
              flush=True)
    with open(os.path.join(out_dir, "dp_rank%d.json" % rank), "w") as f:
        json.dump(res, f, default=float)   # numpy scalars as floats
    if "ops" in res:
        dp_check(res, rank, dev)
    if "dygraph" in res:
        dyg_dp_check(res["dygraph"], rank)
    parallel.shutdown()
    return 0


def dp_check(res, rank, dev):
    """Every check of the dp phase on one rank's results (rank 0 holds
    the by-hand and one-process comparisons); raises on a miss."""
    bad = []
    for op_type, (eo, eg) in res["ops"]["errs"].items():
        if eo > DP_OP_ATOL or eg > DP_OP_ATOL:
            bad.append("%s: out %.3g grad %.3g > %g"
                       % (op_type, eo, eg, DP_OP_ATOL))
    q = res["ops"]["quantized"]
    if not (q["max_abs_err"] <= q["bound"] and q["op_err"] <= q["op_bound"]
            and q["grad_err"] <= DP_OP_ATOL
            and q["op_grad_err"] <= DP_OP_ATOL):
        bad.append("quantized sum %r" % q)
    bn = res["ops"]["sync_batch_norm"]
    if max(bn.values()) > DP_BN_ATOL:
        bad.append("sync_batch_norm %r > %g" % (bn, DP_BN_ATOL))
    for part in ("resnet", "gpt"):
        r = res[part]
        if r["start_spread"] != 0.0 or r["rank_spread"] != 0.0:
            bad.append("%s: ranks differ (start %g, end %g)"
                       % (part, r["start_spread"], r["rank_spread"]))
        if not all(np.isfinite(r["losses"])):
            bad.append("%s: loss not finite %r" % (part, r["losses"]))
    rn = res["resnet"]
    if rn["c_allreduce_sum_ops"] != rn["params"]:
        bad.append("resnet: %d allreduces for %d parameters"
                   % (rn["c_allreduce_sum_ops"], rn["params"]))
    if rank == 0:
        if rn["loss_rel"] > DP_RESNET_LOSS_RTOL:
            bad.append("resnet loss vs by hand %.3g > %g"
                       % (rn["loss_rel"], DP_RESNET_LOSS_RTOL))
        if rn["param_rel"] > DP_RESNET_PARAM_RTOL:
            bad.append("resnet params vs by hand %.3g > %g"
                       % (rn["param_rel"], DP_RESNET_PARAM_RTOL))
        if rn["stat_max_err"] > DP_BN_ATOL:
            bad.append("resnet running stats vs by hand %.3g > %g"
                       % (rn["stat_max_err"], DP_BN_ATOL))
        g = res["gpt"]
        if g["loss_rel"] > DP_GPT_LOSS_RTOL:
            bad.append("gpt loss vs one process %.3g > %g"
                       % (g["loss_rel"], DP_GPT_LOSS_RTOL))
        if g["update_rel"] > DP_GPT_UPDATE_RTOL:
            bad.append("gpt update vs one process %.3g > %g"
                       % (g["update_rel"], DP_GPT_UPDATE_RTOL))
        if res["nccl"]:
            if res["nccl"]["backend"] != "nccl" or max(
                    max(v) for v in res["nccl"]["errs"].values()) != 0.0:
                bad.append("nccl ring %r" % res["nccl"])
    if dev.type == "cuda":
        # 12 layers, one launch of each training kernel a layer a step
        want = 12 * len(res["gpt"]["losses"])
        for k, n in res["gpt"]["launches"].items():
            if n != want:
                bad.append("gpt: %s launched %d times, not %d" % (k, n, want))
    if bad:
        raise AssertionError("dp rank %d: %s" % (rank, "; ".join(bad)))


def launch_dp_workers(spec):
    """One launch of ``DP_RANKS`` workers (this script's ``--dp-worker``
    mode) through ``python -m paddle_tpu_torch.distributed.launch``,
    killed with its workers if it outlives ``DP_TIMEOUT_S``; the
    workers run ``spec``'s parts. Returns what
    each rank wrote, in rank order; raises with the ranks' logs if the
    launch failed."""
    import signal
    import socket
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.abspath(__file__)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(DP_RANKS), "--device", spec["device"],
           "--started_port", str(port - 1000), "--log_dir", out_dir,
           here, "--dp-worker", out_dir, json.dumps(spec)]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(here),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        text += "\nhung past %d s and killed" % DP_TIMEOUT_S
    logs = text[-3000:]
    for r in range(DP_RANKS):
        path = os.path.join(out_dir, "workerlog.%d" % r)
        if os.path.exists(path):
            with open(path) as f:
                logs += "\n--- rank %d ---\n%s" % (r, f.read()[-6000:])
    if proc.returncode != 0:
        for r in range(DP_RANKS):   # what a rank measured before a miss
            path = os.path.join(out_dir, "dp_rank%d.json" % r)
            if os.path.exists(path):
                with open(path) as f:
                    logs += "\n--- rank %d results ---\n%s" % (
                        r, f.read()[:6000])
        shutil.rmtree(out_dir, ignore_errors=True)
        raise RuntimeError("dp: the launch failed (%s)\n%s"
                           % (proc.returncode, logs))
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(out_dir, "dp_rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    return ranks


def dp_phase(dev, spec=None):
    """The dp phase: one launch of ``DP_RANKS`` workers
    (``launch_dp_workers``) running (a)-(d), and the dygraph phase's
    ``DataParallel`` LeNet in the same processes. Returns (line, the
    flash kernels' launches on the data-parallel path summed over the
    ranks); the line's ``dygraph_lenet`` holds each rank's LeNet
    results, which the dygraph phase checks and reports."""
    spec = spec or DP_SPEC
    t0 = time.perf_counter()
    ranks = launch_dp_workers(spec)
    for r, res in enumerate(ranks):
        dp_check(res, r, dev)   # again, on what the ranks wrote
    rn, g = ranks[0]["resnet"], ranks[0]["gpt"]

    def steady(ms):   # past the first step (rewrite, broadcast, warmup)
        return float(np.median(ms[1:])) if len(ms) > 1 else ms[0]

    resnet_rows = [{"rank": r, "images_per_s":
                    spec["resnet"]["batch"] * 1e3 / steady(
                        res["resnet"]["step_ms"]),
                    "step_ms": res["resnet"]["step_ms"],
                    "checked_step_ms": res["resnet"]["checked_step_ms"],
                    "timed_losses": res["resnet"]["timed_losses"],
                    "collective_ms": res["resnet"]["collective_ms"],
                    "collective_calls": res["resnet"]["collective_calls"],
                    "collective_share": steady(res["resnet"]["collective_ms"])
                    / steady(res["resnet"]["step_ms"]),
                    "losses": res["resnet"]["losses"]}
                   for r, res in enumerate(ranks)]
    gpt_rows = [{"rank": r, "step_ms": res["gpt"]["step_ms"],
                 "collective_ms": res["gpt"]["collective_ms"],
                 "tokens_per_s": spec["gpt_batch"] // DP_RANKS
                 * spec["gpt_t"] * 1e3 / steady(res["gpt"]["step_ms"]),
                 "launches": res["gpt"]["launches"]}
                for r, res in enumerate(ranks)]
    launches = {k: sum(res["gpt"]["launches"][k] for res in ranks)
                for k in ranks[0]["gpt"]["launches"]}
    line = {"phase": "dp", "ranks": DP_RANKS, "backend": "gloo",
            "device_per_rank": "%s:0 (both ranks share one card, so these "
            "numbers do not show scaling)" % spec["device"],
            "ops": ranks[0]["ops"], "ops_rank1": ranks[1]["ops"],
            "resnet": {"config": "BASELINE.json config 4",
                       "spec": spec["resnet"],
                       "params": rn["params"],
                       "c_allreduce_sum_ops": rn["c_allreduce_sum_ops"],
                       "loss_rel": rn["loss_rel"],
                       "loss_rtol": DP_RESNET_LOSS_RTOL,
                       "param_rel": rn["param_rel"],
                       "param_max_abs_err": rn["param_max_abs_err"],
                       "param_rtol": DP_RESNET_PARAM_RTOL,
                       "stat_max_err": rn["stat_max_err"],
                       "hand_losses": rn["hand_losses"],
                       "ranks": resnet_rows},
            "gpt": {"model": spec["gpt"], "rows_per_rank":
                    spec["gpt_batch"] // DP_RANKS, "seq": spec["gpt_t"],
                    "params": g["params"],
                    "joined_losses": g["joined_losses"],
                    "single_losses": g["single_losses"],
                    "loss_rel": g["loss_rel"], "loss_rtol": DP_GPT_LOSS_RTOL,
                    "update_rel": g["update_rel"],
                    "update_rtol": DP_GPT_UPDATE_RTOL, "ranks": gpt_rows},
            "nccl": ranks[0]["nccl"],
            "rank_seconds": [res["seconds"] for res in ranks],
            "peak_bytes": [res.get("peak_bytes") for res in ranks],
            "launches": launches,
            "dygraph_lenet": [res.get("dygraph") for res in ranks],
            "seconds": time.perf_counter() - t0}
    print("dp phase seconds: %.1f" % line["seconds"], flush=True)
    return line, launches


# ---------------------------------------------------------------------------
# phase 23: dygraph — BERT-base written as fluid.dygraph Layers beside its
# static program, and DataParallel LeNet over 2 ranks
# ---------------------------------------------------------------------------
DYG_STEPS = 3           # the checked Adam steps, dygraph beside static
DYG_TIMED_STEPS = 5
# The dygraph classifier against the static program at the same weights:
# the same fp32 functions (Linear's ``matmul`` where the program's fc has
# ``mul``: the same GEMMs), so the losses agree to a few ulps; per
# parameter gradient relative norm, floored as the bert phase floors it.
DYG_LOSS_RTOL = 1e-5
DYG_GRAD_RTOL = 1e-4
# DataParallel LeNet (DP_SPEC's lenet_*: 2 ranks of 32 images against one
# process on 64, SGD, cuDNN's deterministic algorithms): only the
# all-reduce's sum of the two halves' gradients rounds differently. A
# whole run takes it from the dp phase's workers; --only dygraph launches
# its own with DYG_DP_SPEC.
DYG_DP_SPEC = dict({k: DP_SPEC[k] for k in ("device", "lenet_batch",
                                             "lenet_steps", "lenet_lr")},
                   parts=["dygraph"])
DYG_DP_LOSS_RTOL = 1e-5
DYG_DP_UPDATE_RTOL = 1e-4


class _PlainFlashCalls(object):
    """Counts the flash plain versions' calls inside (the port's wrappers
    call them only for CPU tensors): {"fwd": n, "bwd": n}."""

    def __enter__(self):
        from paddle_tpu_torch.kernels import flash_attention as fa

        self.fa = fa
        self.saved = (fa.flash_attention_lse_plain,
                      fa.flash_attention_bwd_plain)
        self.calls = {"fwd": 0, "bwd": 0}

        def counted(key, fn):
            def call(*a, **k):
                self.calls[key] += 1
                return fn(*a, **k)
            return call

        fa.flash_attention_lse_plain = counted("fwd", self.saved[0])
        fa.flash_attention_bwd_plain = counted("bwd", self.saved[1])
        return self.calls

    def __exit__(self, *exc):
        (self.fa.flash_attention_lse_plain,
         self.fa.flash_attention_bwd_plain) = self.saved


def dyg_dp_lenet(rank, world, dev, spec):
    """The dygraph phase's worker part: LeNet-5
    (``testing.dygraph_models.make_lenet``) under ``fluid.dygraph.guard``
    wrapped in ``DataParallel`` (``prepare_context``, ``scale_loss``,
    ``apply_collective_grads``), each rank on its half of every batch,
    SGD, cuDNN deterministic; then rank 0 runs one process on the whole
    batches from the same weights."""
    import torch.distributed as dist

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.testing import dygraph_models as dm

    t_part = time.perf_counter()
    B, steps = spec["lenet_batch"], spec["lenet_steps"]
    rs = np.random.RandomState(23)
    batches = [(rs.rand(B, 1, 28, 28).astype(np.float32),
                rs.randint(0, 10, (B, 1)).astype(np.int64))
               for _ in range(steps)]
    place = _dp_place(dev)
    strategy = fluid.dygraph.prepare_context()
    env = fluid.dygraph.ParallelEnv()
    init = None

    def run(data_parallel):
        nonlocal init
        with fluid.dygraph.guard(place):
            lenet = dm.make_lenet(fluid)
            if init is None:
                wrs = np.random.RandomState(24)
                init = {k: (wrs.standard_normal(v.shape) * 0.1).astype(
                    np.float32) for k, v in lenet.state_dict().items()}
            lenet.set_dict(init)
            model = fluid.dygraph.DataParallel(lenet, strategy) \
                if data_parallel else lenet
            opt = fluid.optimizer.SGD(learning_rate=spec["lenet_lr"],
                                      parameter_list=lenet.parameters())
            per = B // world if data_parallel else B
            lo = rank * per if data_parallel else 0
            losses, ms = [], []
            for img, lab in batches:
                _dp_sync(dev)
                t0 = time.perf_counter()
                logits = model(fluid.dygraph.to_variable(img[lo:lo + per]))
                loss = fluid.layers.mean(
                    fluid.layers.softmax_with_cross_entropy(
                        logits, fluid.dygraph.to_variable(
                            lab[lo:lo + per])))
                if data_parallel:
                    loss = model.scale_loss(loss)
                loss.backward()
                if data_parallel:
                    model.apply_collective_grads()
                opt.minimize(loss)
                lenet.clear_gradients()
                value = float(loss.numpy().reshape(-1)[0])
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(value * (world if data_parallel else 1))
            params = {k: v.value.detach().clone()
                      for k, v in lenet.state_dict().items()}
        return losses, ms, params

    with _cudnn_deterministic(True):
        losses, ms, params = run(True)
        out = {"nranks": env.nranks, "local_rank": env.local_rank,
               "losses": losses, "step_ms": ms,
               "rank_spread": _dp_rank_spread(list(params.values())),
               "params": len(params)}
        rank_losses = _dp_gather(losses, dev)
        if rank == 0:
            single, _ms, sparams = run(False)
            joined = np.mean(rank_losses, axis=0)
            base = {k: torch.as_tensor(v, device=dev)
                    for k, v in init.items()}
            out.update(
                single_losses=single, joined_losses=joined.tolist(),
                loss_rel=float(np.max(np.abs(joined - single)
                                      / np.abs(single))),
                update_rel=_dp_rel_norm(params, sparams, base))
    dist.barrier()
    out["seconds"] = time.perf_counter() - t_part
    return out


def dyg_dp_check(res, rank):
    """The dygraph worker part's checks on one rank's results; raises on
    a miss."""
    bad = []
    if (res["nranks"], res["local_rank"]) != (DP_RANKS, rank):
        bad.append("ParallelEnv read %r" % ((res["nranks"],
                                             res["local_rank"]),))
    if res["rank_spread"] != 0.0:
        bad.append("ranks end apart (%g)" % res["rank_spread"])
    if not all(np.isfinite(res["losses"])):
        bad.append("loss not finite %r" % (res["losses"],))
    if rank == 0:
        if res["loss_rel"] > DYG_DP_LOSS_RTOL:
            bad.append("loss vs one process %.3g > %g"
                       % (res["loss_rel"], DYG_DP_LOSS_RTOL))
        if res["update_rel"] > DYG_DP_UPDATE_RTOL:
            bad.append("update vs one process %.3g > %g"
                       % (res["update_rel"], DYG_DP_UPDATE_RTOL))
    if bad:
        raise AssertionError("dygraph DataParallel rank %d: %s"
                             % (rank, "; ".join(bad)))


def dygraph_phase(dev, dp_lenet=None):
    """BERT-base's classifier written as ``fluid.dygraph`` Layers
    (``testing.dygraph_models.make_bert_classifier``: Embedding, Linear,
    LayerNorm and ``fluid.layers.flash_attention`` with the mask's key
    bias) at seq 384 and batch 24, fp32, under
    ``fluid.dygraph.guard(CUDAPlace(0))``, beside the static
    ``build_bert_classifier`` program at the same weights (the program's
    startup values, copied by ``bert_static_names``), dropout 0: 3 Adam
    steps each, the losses and the step-1 gradients held to the
    program's; each dygraph step launches each training kernel 12 times
    (counts zeroed just before the 3 steps and read just after), with no
    generic replay and no plain flash call. Then 5 timed steps of each
    (ms p50), one profiled dygraph step (idle share, launches), and
    ``DataParallel`` LeNet on 2 ranks over gloo on the card held to one
    process: ``dp_lenet``, each rank's results from the dp phase's
    launch (its workers run this part too, so a whole run starts no
    second pair of processes), else a launch of its own
    (``launch_dp_workers`` with ``DYG_DP_SPEC``). Returns (line, the
    training kernels' launches in the 3 steps)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.ops import registry
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.testing import dygraph_models as dm

    t_phase = time.perf_counter()
    n_layers = bert.BertConfig.base().num_layers
    cfg = bert.BertConfig.base(use_flash_attention=True, hidden_dropout=0.0,
                               attention_dropout=0.0)
    feed = bert_feed(BERT_SEQ, BERT_BATCH, seed=4)
    names = dm.bert_static_names(cfg)

    # the static program: its startup weights, 3 checked steps, 5 timed
    t0 = time.perf_counter()
    main, loss, _acc, exe, scope = bert_program(cfg, BERT_SEQ)
    init = {names[n]: scope.get(n).detach().to("cpu", copy=True).numpy()
            for n in names}
    out = exe.run(main, feed=feed, fetch_list=[loss] + [
        n + "@GRAD" for n in names], scope=scope)
    s_losses = [float(out[0].reshape(-1)[0])]
    s_grads = {names[n]: g for n, g in zip(names, out[1:])}
    del out
    step = loss_step(exe, main, loss, feed, scope)
    s_losses += [step() for _ in range(DYG_STEPS - 1)]
    _l, s_ms = timed_steps(step, DYG_TIMED_STEPS)
    static_s = time.perf_counter() - t0
    del main, loss, exe, scope, step
    torch.cuda.empty_cache()

    # the dygraph classifier from the same weights
    order = ("src_ids", "pos_ids", "sent_ids", "input_mask", "label")
    t0 = time.perf_counter()
    with fluid.dygraph.guard(fluid.CUDAPlace(0)):
        model = dm.make_bert_classifier(fluid, cfg, BERT_SEQ)
        model.set_dict(init)
        del init
        opt = fluid.optimizer.Adam(learning_rate=BERT_LR,
                                   parameter_list=model.parameters())

        def forward_backward():
            lv = model(*[fluid.dygraph.to_variable(feed[n]) for n in order])
            lv.backward()
            return lv

        def dy_step(lv=None):
            lv = forward_backward() if lv is None else lv
            opt.minimize(lv)
            model.clear_gradients()
            return float(lv.numpy().reshape(-1)[0])

        build_s = time.perf_counter() - t0
        replays0 = profiler.get_counter(registry.REPLAY_COUNTER)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_launches()
        with _PlainFlashCalls() as plain:
            lv = forward_backward()
            d_grads = {k: v.gradient() for k, v in
                       model.state_dict().items()}
            d_losses = [dy_step(lv)] + [dy_step()
                                        for _ in range(DYG_STEPS - 1)]
        launches = flash_launches()
        replays = profiler.get_counter(registry.REPLAY_COUNTER) - replays0
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        want = n_layers * DYG_STEPS
        if any(n != want for n in launches.values()) or replays or any(
                plain.values()):
            raise AssertionError(
                "dygraph bert: %d steps launched %r (expected %d each), %d "
                "generic replays, plain flash calls %r"
                % (DYG_STEPS, launches, want, replays, plain))
        loss_rel = [abs(d - s) / abs(s) for d, s in zip(d_losses,
                                                         s_losses)]
        rel, gnorm = rel_norms(d_grads, s_grads, GRAD_NORM_FLOOR)
        worst = max(rel, key=rel.get)
        del d_grads, s_grads
        if not (max(loss_rel) <= DYG_LOSS_RTOL
                and rel[worst] <= DYG_GRAD_RTOL):
            raise AssertionError(
                "dygraph bert vs the program: losses %r vs %r, gradient of "
                "%s at relative norm %.3g" % (d_losses, s_losses, worst,
                                              rel[worst]))
        d_timed, d_ms = timed_steps(dy_step, DYG_TIMED_STEPS)
        if not all(np.isfinite(d_timed)):
            raise AssertionError("dygraph bert losses %r" % (d_timed,))
        prof = _profile(dy_step, reps=1)
        del model, opt
    torch.cuda.empty_cache()

    # DataParallel LeNet: 2 ranks over gloo on this card
    t0 = time.perf_counter()
    if dp_lenet is None:
        dp_lenet = [res["dygraph"] for res in launch_dp_workers(DYG_DP_SPEC)]
        launched = "its own"
    else:
        launched = "the dp phase's"
    for r, res in enumerate(dp_lenet):
        dyg_dp_check(res, r)
    dp0 = dp_lenet[0]
    line = {
        "phase": "dygraph", "model": "bert-base", "seq_len": BERT_SEQ,
        "batch": BERT_BATCH, "learning_rate": BERT_LR,
        "static_build_and_steps_s": static_s, "dygraph_build_s": build_s,
        "vs_static": {
            "dygraph_losses": d_losses, "static_losses": s_losses,
            "loss_rel": loss_rel, "loss_rtol": DYG_LOSS_RTOL,
            "max_grad_rel_norm": rel[worst], "worst_param": worst,
            "median_grad_rel_norm": float(np.median(list(rel.values()))),
            "params": len(rel), "grad_rtol": DYG_GRAD_RTOL,
            "grad_norm": gnorm},
        "launches": launches,
        "launches_per_step": {k: n / DYG_STEPS for k, n in launches.items()},
        "generic_grad_replays": replays, "plain_flash_calls": plain,
        "dygraph_step_ms": d_ms,
        "dygraph_step_ms_p50": float(np.median(d_ms)),
        "static_step_ms": s_ms,
        "static_step_ms_p50": float(np.median(s_ms)),
        "dygraph_over_static": float(np.median(d_ms) / np.median(s_ms)),
        "device_idle_share": prof["device_idle_share"],
        "profile_step": prof, "peak_mem_mib": peak,
        "data_parallel": {
            "model": "lenet", "ranks": DP_RANKS, "backend": "gloo",
            "spec": {k: DYG_DP_SPEC[k] for k in (
                "lenet_batch", "lenet_steps", "lenet_lr")},
            "params": dp0["params"],
            "joined_losses": dp0["joined_losses"],
            "single_losses": dp0["single_losses"],
            "loss_rel": dp0["loss_rel"], "loss_rtol": DYG_DP_LOSS_RTOL,
            "update_rel": dp0["update_rel"],
            "update_rtol": DYG_DP_UPDATE_RTOL,
            "step_ms": [res["step_ms"] for res in dp_lenet],
            "workers": "%s launch" % launched,
            "rank_seconds": [res["seconds"] for res in dp_lenet],
            "seconds": time.perf_counter() - t0},
        "seconds": time.perf_counter() - t_phase,
    }
    # the phase's work with the LeNet ranks' own, which a whole run spends
    # inside the dp phase's launch (and counts in that phase's seconds)
    line["seconds_with_lenet_ranks"] = line["seconds"] + (
        max(line["data_parallel"]["rank_seconds"])
        if launched != "its own" else 0.0)
    print("dygraph phase seconds: %.1f" % line["seconds"], flush=True)
    return line, launches


def gpt2_small(dev):
    """GPT-2 small's widths, random weights from seed 0."""
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(use_flash_attention=True)
    model = gpt.GPTLM(cfg, device=dev)
    gpt.load_fluid_params(model, gpt.init_fluid_params(cfg, seed=0))
    return model


ONLY_PHASES = ("engine_features", "program_train", "inference_server",
               "gateway", "fleet", "programs", "bert", "vision", "nmt",
               "recompute", "rnn", "train_runtime", "dp", "dygraph",
               "op_corpus")


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
                elif phase == "recompute":
                    line = recompute_phase(dev)[0]
                elif phase == "rnn":
                    line = rnn_phase(dev)
                elif phase == "train_runtime":
                    line = train_runtime_phase(dev)[0]
                elif phase == "dp":
                    line = dp_phase(dev)[0]
                elif phase == "dygraph":
                    line = dygraph_phase(dev)[0]
                elif phase == "op_corpus":
                    line = op_corpus_phase(dev)[0]
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
    if argv[:1] == ["--dp-worker"]:
        return dp_worker_main(argv[1:])

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma list of phases to run alone after the build "
                         "(engine_features, program_train, "
                         "inference_server, gateway, fleet, programs, bert, "
                         "vision, nmt, recompute, rnn, train_runtime, dp, "
                         "dygraph, op_corpus)")
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
    oc_run, oc_launches = op_corpus_phase(dev, adam={
        "step_ms_p50": bert_run["fp32"]["step_ms_p50"],
        "peak_mem_mib": bert_run["fp32"]["peak_mem_mib"],
        "from": "the bert phase"})
    emit(dict(oc_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    emit(dict(vision_phase(dev), device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    nmt_run, nmt_launches = nmt_phase(dev)
    emit(dict(nmt_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    rc_run, rc_launches = recompute_phase(dev)
    emit(dict(rc_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    emit(dict(rnn_phase(dev), device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    tr_run, tr_launches = train_runtime_phase(dev)
    emit(dict(tr_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    dp_run, dp_launches = dp_phase(dev)
    emit(dict(dp_run, device=name, nvidia_smi=smi))
    torch.cuda.empty_cache()
    dyg_run, dyg_launches = dygraph_phase(dev, dp_run["dygraph_lenet"])
    emit(dict(dyg_run, device=name, nvidia_smi=smi))
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

    # each phase's wall seconds (from the line before it to its own)
    print(json.dumps({"phase_seconds": _PHASE_SECONDS}), flush=True)

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
                + bert_launches["bert"][kname] + nmt_launches["nmt"][kname]
                + rc_launches["recompute_bert"][kname] + tr_launches[kname]
                + dp_launches[kname] + dyg_launches[kname]
                + oc_launches[kname],
                "launches_by_path": {"train_eager": train_launches[kname],
                                     "train_program": program_launches[kname],
                                     "bert": bert_launches["bert"][kname],
                                     "nmt": nmt_launches["nmt"][kname],
                                     "recompute_bert":
                                         rc_launches["recompute_bert"][kname],
                                     "train_runtime": tr_launches[kname],
                                     "dp": dp_launches[kname],
                                     "dygraph": dyg_launches[kname],
                                     "op_corpus": oc_launches[kname]},
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
         + nmt_launches["nmt"]["flash_fwd"]
         + rc_launches["recompute_bert"]["flash_fwd"]
         + tr_launches["flash_fwd"] + dp_launches["flash_fwd"]
         + dyg_launches["flash_fwd"] + oc_launches["flash_fwd"],
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
                              "nmt": nmt_launches["nmt"]["flash_fwd"],
                              "recompute_bert":
                                  rc_launches["recompute_bert"]["flash_fwd"],
                              "train_runtime": tr_launches["flash_fwd"],
                              "dp": dp_launches["flash_fwd"],
                              "dygraph": dyg_launches["flash_fwd"],
                              "op_corpus": oc_launches["flash_fwd"]},
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
