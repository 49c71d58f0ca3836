#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``mxnet_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py              # the run that must pass
    python3 chip_smoke.py --profile    # also torch.profiler tables of one
                                       # decode step and one train step,
                                       # by kernel
    python3 chip_smoke.py --kernels    # phases 1 and 2 only (no result)
    python3 chip_smoke.py --resnet     # phases 1 and 9 only (no result)
    python3 chip_smoke.py --spec       # phases 1, 2 at phase 10's shapes,
                                       # and 10 (no result)
    python3 chip_smoke.py --front      # phases 1 and 11 only (no result)
    python3 chip_smoke.py --zoo        # phases 1, 2 and 12 only (no
                                       # result)
    python3 chip_smoke.py --options    # phases 1 and 13 only (no result)
    python3 chip_smoke.py --graphtrain # phases 1 and 14 only (no result)
    python3 chip_smoke.py --array      # phases 1 and 15 only (no result)
    python3 chip_smoke.py --detect     # phases 1 and 16 only (no result)
    python3 chip_smoke.py --data       # phases 1 and 17 only (no result)
    python3 chip_smoke.py --serve-ab=A,B,B,A [--rounds=20]
                                       # phase 3's workload on the
                                       # engine of each tree listed
                                       # (each holding mxnet_tpu_torch/),
                                       # one process each (no result)
    python3 chip_smoke.py --trials     # also, after phase 1, trial builds
                                       # of K4's span, K1 forward's
                                       # tiling, K5a's cluster size,
                                       # threads and slab copies, and
                                       # K5b's rows, stages, threads and
                                       # row route (and two diagnostic
                                       # builds each of K5a and K5b)
                                       # timed against each other
    python3 chip_smoke.py --trials=K5b # only the trials whose label
                                       # holds "K5b"

Phases (each asserts; any failure exits non-zero before the result line):

1. Environment: the card's name and power limit, the matmul precision
   policy set to ``highest`` (IEEE f32 in cuBLAS and cuDNN, 3xTF32 in the
   attention kernels; every check below runs under it unless it names
   the ``default`` policy, TF32), and the build of every CUDA kernel from
   ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, all started
   together).
2. Kernel checks: each kernel of the serving path (K2 LayerNorm, K4 paged
   attention, K5a QKV projection + int8 KV quantize, K5b out projection)
   against its plain PyTorch version on the card, at the shapes the main
   path gives it, with its device time, its plain version's, that of one
   PyTorch library call computing the same function where there is one,
   and its bound from bytes and operations. K5a's int8 rounding is also
   held to exactly known rows on inputs built to expose a wrong rounding
   (:func:`qkv_rounding_probe`), and every other dtype variant the
   wrappers launch (bfloat16 activations, bfloat16 / float16 / float32
   KV stores and pools) is checked against its plain version once. The
   training slice's kernels (K1 flash-attention forward, K1c dQ, K1d
   dK/dV, K3 logsumexp) are timed at the train step's shapes and checked
   in their other cases (:func:`train_kernel_checks`); the three
   attention kernels must give bitwise-equal results on two runs, K1
   forward must beat SDPA's forward, and their bound is that of the
   tensor cores they run on (three TF32 passes in f32), with the f32-FMA
   bound printed beside it; cuobjdump must find HMMA in every
   instantiation. The same three kernels on the ``default`` policy's
   route, f32 in one TF32 pass (:func:`one_pass_checks`), are held
   against the plain versions that round their operands to TF32 and
   against the exact ones, run twice for the same bits, and timed against
   their one-pass bound and SDPA under the same policy. K4 is timed at phase 3's mid-decode lengths too, must
   beat its plain version, and is held at the edges of its split
   (:func:`paged_edge_checks`). K2 is checked and timed on both of its
   routes at the decode, prefill and train shapes (the warp route through
   the wrapper, the block route through its C entry), and on the block
   route through the wrapper at widths the warp route does not take
   (4096, 770). K5a runs as a thread-block cluster fed by bulk copies:
   cuobjdump must find the bulk copy in every instantiation and the
   cluster barrier in the int8 ones; two runs must give the same bits;
   20 tokens (three chunks) and a width on its head route (U 4096) must
   give the plain version's rows byte for byte on exact inputs. K5b runs
   on every SM, a block's weight rows brought in by bulk copies through
   a ring of stages: cuobjdump must find the bulk copy in both of its
   instantiations; its geometry is printed; two runs must give the same
   bits; and 20 tokens, a U_out no block size divides, U 4096, a width
   whose rows the ring walks (U_in 4608, 20 tokens), bfloat16 and a
   width on its row route (U_in 8192) must give the plain version's
   outputs byte for byte on exact inputs. A near-empty launch
   (:func:`launch_floor`) is timed beside K2, K5a and K5b.
   K2r (RMSNorm
   forward) and R (runtime-compiled user kernels) are checked at the
   front-door path's shapes (:func:`frontdoor_kernel_checks`). At
   phase 10's shapes (:func:`spec_shape_checks`): K5a and K5b at N 64
   (verify: 16 lanes x K+1) and N 32 (a suffix bucket), byte for byte on
   exact inputs and timed beside ``F.linear`` at the same N, and K4 over
   the verify's 64 virtual lanes, whose tables share the prefix blocks.
3. The main path: gpt_like at full width (vocab 32000, units 768, hidden
   3072, 12 layers, 12 heads, max_length 2048) with seeded numpy weights
   loaded through ``from_jax_params``, served by ``LLMEngine`` with its
   defaults (int8 KV, block 16, 8 lanes) for 8 requests, after
   ``warmup`` captured the decode step and the prompts' prefill buckets
   as CUDA graphs; the served run replays them, and every kernel's
   launch count over it must be exactly what its prefills and decode
   steps imply.
4. Output checks, at the served batch's mid-decode lengths: one paged
   decode step's logits with the kernels, and with
   ``MXNET_TPU_LLM_FUSED_DECODE=0`` (cuBLAS projections around K4),
   against the same step on the plain path (``no_kernels``); greedy
   tokens of the paged engine (f32 KV, graphs) against the dense-cache
   ``generate``; one replay of the decode graph, and of a prefill
   bucket's, against one eager call of the same program, bitwise in
   tokens, pools and launches (:func:`replay_equals_eager`); a sampling
   engine's graphs draw anew from its generator (:func:`sampling_check`).
5. Step times: the same decode step replayed and eager, on the kernels
   and on the plain path, and each served prefill bucket replayed and
   eager, device time against host time.
6. Train-step check: one full-width backward at B 2, L 1024 through the
   kernels against the same under ``no_kernels``, and under the
   ``default`` policy against ``highest`` (:func:`train_grad_check`).
7. The train main path: the same gpt_like trains through
   ``SoftmaxCrossEntropyLoss`` and ``Trainer`` (SGD, momentum 0.9) on 8
   sequences of 1024 seeded tokens, under ``highest`` and then under
   ``default``, each a warm-up step and 5 timed steps with exact launch
   counts and a falling loss (:func:`train_phase`).
8. The front-door path (:func:`frontdoor_phase`): the RMSNorm FFN stack at
   gpt_like's widths (12 blocks of x + Dense(768)(Dense(3072, gelu)(
   RMSNorm()(x))) and a final RMSNorm, every layer with a deferred shape)
   built with Gluon, ``net.initialize(Xavier())``, data from
   ``mx.np.random``, scaled per row by a user kernel compiled with
   ``mx.rtc.CudaModule`` (NVRTC), trained through ``autograd.record()``,
   ``L2Loss`` and ``Trainer(net.collect_params(), "adam")``: shapes
   completed at the first forward, then under each policy exactly 13 K2r
   launches per forward (one RMSNorm per block and the final one) and
   one user-kernel launch per step and a falling loss, a B 2 step's loss
   and gradients against ``no_kernels`` and under ``default`` against
   ``highest``, and a bitwise ``.params`` round trip. Its kernels (K2r RMSNorm, kernel R through two user sources) are
   checked in phase 2 (:func:`frontdoor_kernel_checks`).

9. The ResNet path (:func:`resnet_phase`): ResNet-50 v1 at full width
   (classes 1000, 224x224, batch 32) through ``vision.get_model``,
   ``initialize()``, a forward that completes the deferred shapes and
   seeded weights through ``from_jax_params``. Inference eager and
   hybridized (one CUDA graph, replayed) under ``highest``, ``default``
   and in bfloat16 after ``net.cast("bfloat16")``, with img/s, host and
   device ms and the busy share: a replay equals an eager call bitwise,
   ``functionalize``'s fn equals the block bitwise, computes with the
   params it is given and leaves them unchanged, a training-mode (not recording) replay equals the eager
   call in its output and running statistics
   (:func:`train_mode_replay`), the logits hold against the port on the
   CPU (highest),
   and default and bfloat16 against highest. Training through
   ``SoftmaxCrossEntropyLoss`` and ``Trainer(net.collect_params(),
   "sgd")`` (lr 0.05, momentum 0.9) under each policy: a falling loss,
   moved running statistics that the Trainer leaves alone, K3 once per
   step and no other kernel, and a B 4 step's loss and gradients under
   default against highest and on the card against the CPU
   (:func:`resnet_grad_checks`). It prints BASELINE.md's V100 rows beside the card's
   numbers as the published yardstick. The path runs no kernel of the
   port but K3 (the loss): convolution, pooling and BatchNorm are cuDNN
   and torch's own kernels, as the reference leaves them to XLA.
10. Speculative decoding and the shared-prefix block cache
   (:func:`spec_prefix_phase`), on ``benchmark/llm_serve_bench.py``'s
   ``spec_prefix`` workload at its full settings (SPEC_* below): the
   full-width gpt_like with its upper layers damped as the target, a
   1-layer draft holding its embeddings and layer 0, 48 requests sharing
   a 448-token prefix, 16 lanes, int8 KV, ``draft_k`` 3. After an
   untimed priming run, the spec+prefix engine's greedy tokens equal the
   plain engine's exactly (a difference prints the target's top-2 logit
   gap there), both timed runs launch exactly what their rounds, steps
   and prefills imply, the prefix hit rate is above 0.9 and the cache
   holds the prompts' full blocks and nothing else; an f32-KV spec+prefix
   engine gives the dense ``generate``'s tokens; one replay of each of
   the draft, verify and suffix-prefill programs equals one eager call
   bitwise (:func:`spec_replay_equals_eager`); a sampling spec engine
   draws anew. It prints both engines' tok/s, the acceptance and hit
   rates, a spec round's device and host ms replayed and eager, and the
   suffix prefill against the full prefill of the same prompt lengths,
   and the smallest top-2 logit gap of the target along both engines'
   greedy paths (dense f32-KV forwards of each prompt and its tokens).
11. The training front door (:func:`front_phase`), under ``default``:
   ``example/gluon/image_classification.py``'s loop on phase 9's
   ResNet-50 (B 32) with ``Trainer(net.collect_params(), "nag")`` under
   a ``MultiFactorScheduler`` with warmup, ``SoftmaxCrossEntropyLoss``
   and a ``CompositeEvalMetric`` of Accuracy, TopKAccuracy(5) and Loss
   for 6 steps: each step's rate equals the schedule's closed form, K3
   once a step and no other kernel of the port, a falling loss, metrics
   equal to the counts taken on the host, img/s and step ms; after step
   3 a ``save_states``/``load_states`` round trip into a fresh Trainer
   gives bitwise-equal states, and both Trainers' updates from one set
   of gradients bitwise-equal weights. The same net after
   ``net.cast("bfloat16")`` takes 3 steps of ``SGD(multi_precision=
   True)``: float32 masters, each weight its master rounded bitwise, K3
   in bfloat16, a falling loss. Phase 7's gpt_like takes 3 steps of LAMB
   under a ``CosineScheduler`` with the ``Perplexity`` metric: phase 7's
   launches of K1 forward, K1c, K1d, K2 and K3 per step, a falling loss,
   the perplexity equal to exp of the mean loss. Every registered
   optimizer takes one update of gpt_like's (32000, 768) embedding and a
   (768,) bias on the card, held against the port on the CPU, and is
   timed.
12. BERT-base pretraining and the rest of the model zoo
   (:func:`zoo_phase`). ``BERTForPretraining(bert_base(dropout=0.0))``
   (vocab 30522, units 768, 12 layers, 12 heads), ``initialize()`` on
   the card: one step with the MLM and NSP losses, its loss and
   gradients against ``no_kernels`` under highest and in norm under
   default against highest (K1 forward, K1c, K1d 12 each, K2 26, K3 2),
   then at ``benchmark/train_bench.py``'s settings (B 32, L 128, SGD
   momentum 0.9, lr 0.05 on the MLM loss over every position) a warm-up
   and 3 timed steps under each policy with exact launches (K3 once) and
   a falling loss; one default step profiled by kind into
   ``chiprun_out/bert_train_profile.txt``; 4 steps on the MLM plus the
   NSP loss at those settings print both losses (the NSP head diverges
   there). BERT
   inference under highest: bert_base without valid_length (K1) and with
   a ragged one (the masked plain path), bert_large at B 8, L 512, held
   against ``no_kernels``. AlexNet, VGG-16 (and ``_bn``), SqueezeNet
   1.1, DenseNet-121, Inception V3, MobileNet 1.0 and V2 at B 32 under
   default, eager and replayed (bitwise equal), their B 2 logits under
   highest against the CPU; a mobilenetv2_1.0 train step (K3 once, the
   loss falling). ``pretrained=True``: resnet18_v1 and mobilenetv2_1.0
   generated on the host with the port's numpy threefry, their hashes
   the model store's manifest, their training-mode logits on the card
   equal to ``tests/golden``'s. Phase 2 holds and times K1 non-causal at
   BERT's (32, 12, 128, 64) under both policies and K3 on its unaligned
   route at (4096, 30522) and (32, 2) (:func:`bert_kernel_checks`).
13. LLMEngine's single-engine options (:func:`options_phase`) on phase
   3's gpt_like (seeded weights, under ``highest``). Weight-only int8
   (:func:`options_int8`): an engine with ``weight_dtype="int8"`` (int8
   KV, 8 lanes, block 16) serves phase 3's 8 requests after ``warmup``
   with exact launches, token for token equal to a plain engine over a
   copy of the model holding ``dequantize(quantize(W))`` (bitwise the
   same arithmetic, so a weight read that missed the substitution
   fails it), beside the f32-weight engine (tok/s, peak memory); an
   f32-KV int8-weight engine gives ``generate(weight_dtype="int8")``'s
   tokens; a replay of the int8-weight decode step equals an eager call
   bitwise, and it is timed beside the f32 step. Beam search
   (:func:`options_beam`, B 2, beam 4, 128-token prompts, 32 new, f32
   and int8 weights): sequences equal and scores within 1e-4 against
   ``no_kernels()`` and against the port on the CPU at 8 tokens, an eos
   that fires, exactly 2L+1 K2 launches a step. The resumed session of
   ``benchmark/kv_economy_bench.py`` at full width
   (:func:`options_spill`): with the host spill tier, without spill,
   and with an 8 MiB host tier over a disk tier, every resume's tokens
   equal the first turn's, the 60 full blocks re-attach from the host
   (the disk) tier byte-equal to the rows the first turn wrote, exact
   launches, the median time to first token and the save and re-attach
   rates. The seams (:func:`options_seams`): ``LLMMetrics`` against
   ``stats()``, every ``llm_decode`` span's trace ids, the step hook once
   a tick, ``chaos.scope("serving.llm")`` failing exactly one request
   typed, and a saved manifest warming a second engine that then
   captures nothing new. Last, one in-place SGD step
   (:func:`options_sgd`): ``generate(weight_dtype="int8")`` quantizes
   once over two calls and follows the new weights.
14. The compiled training step (:func:`graphtrain_phase`), under
   ``default``: a hybridized block under ``autograd.record()`` records
   one node whose forward and backward replay CUDA graphs, and the
   Trainer's update replays one graph over device scalars. Every
   fusable optimizer's captured update (3 steps, the rate halving each
   step, bf16 masters for multi-precision SGD) bitwise equal to its
   eager one (:func:`gt_optimizers`); a small MLP's recorded node
   (a ``grad_req="add"`` weight over two backwards, an input's
   gradient, two calls of a key pending at once, the second's pair
   dropped after its backward) bitwise eager (:func:`gt_node_semantics`). ResNet-50 v1 (B 32, 224x224, phase
   11's NAG loop, shapes by ``infer_shape``) and BERT-base (B 32, L
   128, the MLM loss, SGD) each train 3 steps eager, eager again and
   graphed from one seed: weights and BatchNorm statistics bitwise
   where the two eager runs are, else in norm; launches per replayed
   step exact (ResNet K3 1; BERT K1 forward, K1c, K1d 12 each, K2 26,
   K3 1); then 10 timed and 2 profiled steps print step ms (median,
   range), device ms, busy share, launches outside graphs, captures
   and peak memory (:func:`gt_train`). BERT with dropout 0.1: replays
   draw new masks and the loss follows eager's.
   ``torch.func.grad`` of BERT's ``functionalize`` fn against autograd
   and ``vmap`` of it over 2 x B4 (:func:`gt_torch_func`). BERT with
   every ``grad_req`` "add", two recorded micro-batches of B 16 and
   one step: gradients and weights bitwise eager
   (:func:`gt_accumulate`).
15. The array layer (:func:`array_phase`), under ``highest``: every
   function this PR ported (``mx.np`` with ``linalg``, ``fft`` and
   ``random``, ``mx.npx`` with its ``random``) on cuda:0 at gpt_like's
   (8192, 768) activations in f32 and int64, token ids (8, 1024),
   logits (8, 32000), batched matrices (64, 256, 256) and an fft over
   (8, 1024, 768), each held against the same call on a CPU copy at the
   CPU tests' tolerances (linear algebra on its first 8 matrices, the
   elementwise family on its first 1024 rows), every output on cuda:0,
   the count swept equal
   to the modules' public callables less the listed exclusions, ms per
   family; 2**24 draws per sampler held on their moments
   (:func:`array_sweep`). Negative and too-large indices through take,
   pick, gather_nd, scatter_nd, one_hot and the index ops, a
   synchronize after each, the context healthy after
   (:func:`array_out_of_range`). MXNet's interleaved self-attention at
   BERT-base's widths (L 128, B 32, H 12, D 64) from layer 0's weights
   of the port's bert_base: against ``ops.nn.attend`` with exactly one
   K1 forward launch at full lengths, and against its masked path at
   valid lengths 64..128 (:func:`array_selfatt`). A hybridized block
   calling ``np.nonzero`` raises MXNetError in its capture
   (:func:`array_capture_guard`).
16. SSD300 detection and the contrib ops (:func:`detect_phase`). SSD300
   as published (Liu et al., ECCV 2016: six maps, 8732 anchors, 21
   classes) over the port's resnet50_v1 body at 300x300 and three extra
   blocks, trained 10 steps as ``example/gluon/ssd.py`` trains it (B 32
   synthetic images of 1-8 rectangles, ``npx.multibox_target`` under
   ``autograd.pause()`` with 3:1 hard negatives, the weighted cross
   entropy and the masked L1, ``Trainer(..., "adam")`` at 2e-3) under
   ``default``: a falling loss, K3 exactly once a step and no other
   kernel, step ms, img/s, peak memory, and ``multibox_target``'s ms,
   share of the step and launches (:func:`det_train`). A held-out batch
   decoded by ``npx.multibox_detection`` (threshold 0.01, NMS 0.45, top
   400) with its ms and the recall at IoU 0.5 through ``npx.box_iou``
   (printed); ``box_nms`` over one image's 8732 decoded boxes and
   ``bipartite_matching`` of its anchors against its ground truths. The
   four run under ``torch.cuda.set_sync_debug_mode("error")`` and are
   held against their CPU copies: class ids, matches and masks exactly
   (a difference only where an IoU lies within 1e-6 of its threshold,
   printed), values within 1e-5 of 1 + the largest (:func:`det_eval`).
   Under ``highest``, each against its CPU copy with device ms (and
   backward ms): ``roi_align`` at Mask R-CNN's FPN P2 with its gradient,
   ``roi_pooling`` at Fast R-CNN's VGG16 conv5, ``psroi_pooling`` at
   R-FCN's head, both deformable convolutions at a DCN's ResNet-50 res5
   with their gradients and one ``DeformableConvolution`` block,
   ``bilinear_resize_2d`` and ``sync_batch_norm`` at SSD's (32, 256, 38,
   38), ``foreach`` over an LSTM-style cell of 768 units (B 32, 128
   steps) with its gradients, and ``while_loop`` and ``cond`` eagerly,
   captured and replayed in a hybridized block (:func:`det_ops`).
17. The flagship example's data loop (:func:`data_phase`).
   ``example/gluon/image_classification_torch.py`` at its defaults
   (resnet18_v1 at 32x32, 10 classes, B 64, hybridized, SGD) through its
   own ``build``, ``get_data``, ``train_epoch`` and ``evaluate``: one
   epoch of the synthetic ``ArrayDataset`` and of the synthetic
   ``CIFAR10`` under ``transform_first(ToTensor())``, without and with
   ``amp.init()`` (:func:`data_example`). ResNet-50 v1 hybridized at B
   32, 224x224, ``default``, fed by ``gluon.data.DataLoader`` over 256
   seeded uint8 images under ``Compose([ToTensor(), Normalize])`` with 0
   workers, 4 fork workers and 4 threads, ``pin_memory`` off and on,
   without and with AMP: the loader's host ms a batch, step ms, img/s
   against the same steps fed from the card (the loader's share of the
   epoch and of the median step), upload MB/s, peak memory; each loader
   over a 32-batch epoch, and the forked pool's timeline batch by batch
   (:func:`data_resnet`, :func:`data_long_epochs`,
   :func:`data_pool_timeline`). In both, K3 exactly once a step and no
   other kernel, every convolution and dense layer in bfloat16 under AMP
   and K3's input in float32, a finite loss. The card's AMP step against
   the port's CPU copy (loss within 1e-2 beside the control, the card
   without AMP; the cast decisions and the dtypes each op is handed
   identical),
   a new graph pair after ``amp.init()``, and a float16
   ``init_trainer`` overflow that skips the update bitwise and halves
   the scale (:func:`data_amp_cpu`). ``ImageRecordIter`` over 64 .npy
   records at 224 that the phase writes, ``NDArrayIter`` and
   ``PrefetchingIter``: batches bitwise the CPU's, MB/s
   (:func:`data_io`).

The last lines are the card line, one ``{"kernels": [...]}`` line and
``{"ok": true, "device": {...}}``. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
import json
import math
import os
import re
import subprocess
import sys
import time
from contextlib import nullcontext

import numpy as np

SEED = 0
# published H100 SXM peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# dense tensor-core peaks: TF32 and bf16
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
# spin cycles per second for torch.cuda._sleep: at or above the H100's
# highest SM clock (1.98 GHz), so a spin lasts at least as long as asked
SPIN_CYCLES_S = 2e9
CFG = dict(vocab_size=32000, units=768, hidden_size=3072, num_layers=12,
           num_heads=12, max_length=2048)
NEW_TOKENS = 32
# name in the kernels line -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "layer_norm_fwd": ("mxnet_tpu_torch/csrc/layer_norm.cu",
                       "mxnet_tpu/ops/pallas/layer_norm.py:32"),
    "paged_attention": ("mxnet_tpu_torch/csrc/paged_attention.cu",
                        "mxnet_tpu/ops/pallas/paged_attention.py:49"),
    "qkv_project": ("mxnet_tpu_torch/csrc/fused_decode.cu",
                    "mxnet_tpu/ops/pallas/fused_decode.py:92"),
    "out_project": ("mxnet_tpu_torch/csrc/fused_decode.cu",
                    "mxnet_tpu/ops/pallas/fused_decode.py:120"),
    # one kernel for K1a (:70) and K1b (:144); gpt_like's path runs K1b
    "flash_attention_fwd": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                            "mxnet_tpu/ops/pallas/flash_attention.py:144"),
    # K1c and K1d: tensor-core kernels (mma.sync, 3xTF32 for f32)
    "flash_attention_bwd_dq": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                               "mxnet_tpu/ops/pallas/flash_attention.py:379"),
    "flash_attention_bwd_dkv": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:432"),
    # the same three kernels on the default matmul policy's route: f32 in
    # one TF32 pass (OpsTF32)
    "flash_attention_fwd_tf32": ("mxnet_tpu_torch/csrc/flash_attention.cu",
                                 "mxnet_tpu/ops/pallas/flash_attention.py:144"),
    "flash_attention_bwd_dq_tf32": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:379"),
    "flash_attention_bwd_dkv_tf32": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:432"),
    "cross_entropy_lse": ("mxnet_tpu_torch/csrc/cross_entropy.cu",
                          "mxnet_tpu/ops/pallas/cross_entropy.py:34"),
    "rms_norm_fwd": ("mxnet_tpu_torch/csrc/layer_norm.cu",
                     "mxnet_tpu/ops/pallas/layer_norm.py:50"),
    # kernel R: the user's CUDA C (USER_SOURCE below), compiled by
    # mxnet_tpu_torch/rtc.py with NVRTC; the front-door path launches
    # row_absmax_scale
    "rtc_row_absmax_scale": ("mxnet_tpu_torch/rtc.py",
                             "mxnet_tpu/rtc.py:57"),
}
# two user kernels for mx.rtc.CudaModule: an axpy, and a per-row max-abs
# scaling that uses the grid, the block and dynamic shared memory
USER_SOURCE = r"""
extern "C" __global__ void axpy(int n, const float* x, const float* y,
                                float* o) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i] + y[i];
}

extern "C" __global__ void row_absmax_scale(const float* x, int d,
                                            float* o) {
  extern __shared__ float red[];
  const float* xr = x + (size_t)blockIdx.x * d;
  float* orow = o + (size_t)blockIdx.x * d;
  float m = 0.0f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) m = fmaxf(m, fabsf(xr[j]));
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x],
                                                  red[threadIdx.x + s]);
    __syncthreads();
  }
  const float amax = red[0];
  for (int j = threadIdx.x; j < d; j += blockDim.x) orow[j] = xr[j] / amax;
}
"""
ROW_SCALE_THREADS = 256
LINE_KEYS = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, n_inputs=1, iters=100, warmup=5):
    """Time one call of ``fn``. Returns ``(device_ms, host_ms)``.

    ``device_ms`` is the mean over ``iters`` calls enqueued back to back
    between two CUDA events. A spin kernel (``torch.cuda._sleep``) holds
    the stream until the host has enqueued every call, so the events time
    the card's work and not the Python wrapper's; when the host could not
    enqueue them all within the spin (a full launch queue), the run is
    repeated with half as many calls, and when not even one call fits,
    the whole is tried again with a spin twice as long (a host slowed by
    its neighbours enqueues a call in more than twice the time the first
    loop measured); a call with more launches than the launch queue
    holds never fits, and then ``device_ms`` is its kernels' times summed
    by the profiler (:func:`profiled_device_ms`). ``host_ms`` is the
    host's time per
    call in a loop that ends in a synchronise. ``fn(i)`` cycles through
    ``n_inputs`` input sets, so that operands the main path finds cold in
    L2 (one weight set per layer) are cold here too."""
    import torch

    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    for factor in (2e-3, 4e-3, 8e-3):
        n = iters
        while n >= 1:
            spin.record()
            torch.cuda._sleep(int((factor * n * host_ms + 1e-3)
                                  * SPIN_CYCLES_S))
            start.record()
            t0 = time.perf_counter()
            for i in range(n):
                fn(i % n_inputs)
            enqueue_ms = 1e3 * (time.perf_counter() - t0)
            end.record()
            end.synchronize()
            if enqueue_ms < spin.elapsed_time(start):
                return start.elapsed_time(end) / n, host_ms
            n //= 2
    # one call launches more kernels than the launch queue holds behind a
    # spin (an eager DenseNet-121 at batch 32): its kernels' own times
    dev_ms = profiled_device_ms(torch, fn, n_inputs)
    check(dev_ms > 0, "time_ms: one call outlasts a spin of 8x its host "
          "time, and the profiler saw no device time")
    print(f"time_ms: one call outlasts a spin of 8x its host time (more "
          f"launches than the queue holds); device_ms {dev_ms:.4f} is the "
          "sum of its kernels' times by the profiler", flush=True)
    return dev_ms, host_ms


def profiled_device_ms(torch, fn, n_inputs=1, calls=3):
    """The device ms of one call of ``fn``: its kernels' times summed by
    torch.profiler, the mean over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i % n_inputs)
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / calls


def bound_ms(nbytes, flops):
    b, f = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return 1e3 * max(b, f), ("bytes" if b >= f else "operations")


def kernel_name(mangled):
    """A template kernel's mangled name as name<T, DP>, with ", 1-pass"
    for the attention kernels' one-TF32-pass instantiations; others as
    they are."""

    t = re.search(r"([a-z][a-z_]*_kernel)I(13__nv_bfloat16|f|6__half)"
                  r"Li(\d+)E(Lb1E)?", mangled)
    if t is None:
        return mangled
    ty = {"f": "float", "13__nv_bfloat16": "bf16",
          "6__half": "half"}[t.group(2)]
    return f"{t.group(1)}<{ty}, {t.group(3)}{', 1-pass' if t.group(4) else ''}>"


def ptxas_summary(log):
    """(kernel, registers line, spill line) for each kernel in an ``nvcc
    -Xptxas -v`` log."""

    out, fn, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            out.append((fn, line.split(":", 1)[1].strip(), spill))
            fn, spill = None, ""
    return out


def sass_opcodes(lib):
    """``cuobjdump -sass`` of a built kernel library: the count of each
    instruction mnemonic in each kernel, by mangled name, or None where
    the toolkit has no cuobjdump."""
    from collections import Counter

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    ins = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = Counter()
        elif fn is not None:
            m = ins.search(line)
            if m:
                counts[fn][m.group(1)] += 1
    return counts


def sass_mma_counts(lib):
    """The number of tensor-core instructions (HMMA) in each kernel of a
    built library, by mangled name, or None without cuobjdump."""
    ops = sass_opcodes(lib)
    if ops is None:
        return None
    return {fn: sum(c for op, c in ctr.items() if op.startswith("HMMA"))
            for fn, ctr in ops.items()}


# K5a's cluster route and K5b's ring route in SASS: the bulk copy
# (cp.async.bulk) and the cluster barrier (barrier.cluster, cluster.sync);
# mbarrier and fence instructions are printed beside them
SASS_BULK, SASS_CLUSTER_BAR = "BLKCP", "CGABAR"
SASS_SHOWN = ("BLK", "TMA", "CGA", "SYNCS", "FENCE", "MEMBAR")


def bulk_copy_sass_check(path):
    """Every qkv_cluster_kernel (K5a, 8) and out_ring_kernel (K5b, 2)
    instantiation must issue a bulk copy, and the int8 K5a ones
    (``Lb1E``: QUANT true) a cluster barrier; prints the mnemonics found.
    Returns them, or None without cuobjdump."""
    ops = sass_opcodes(path)
    if ops is None:
        print("cuobjdump not found: SASS of fused_decode not inspected")
        return None
    found = {}
    for fn, ctr in ops.items():
        if "qkv_cluster_kernel" not in fn and "out_ring_kernel" not in fn:
            continue
        shown = {op: c for op, c in sorted(ctr.items())
                 if any(k in op for k in SASS_SHOWN)}
        found[fn] = shown
        bulk = sum(c for op, c in shown.items() if SASS_BULK in op)
        cbar = sum(c for op, c in shown.items() if SASS_CLUSTER_BAR in op)
        print(f"cuobjdump -sass fused_decode {fn}: {shown}", flush=True)
        check(bulk > 0, f"{fn}: no bulk copy ({SASS_BULK}) in its SASS")
        check(cbar > 0 or "Lb1E" not in fn or "out_ring" in fn,
              f"{fn}: no cluster barrier ({SASS_CLUSTER_BAR}) in its SASS")
    counts = [sum(k in fn for fn in found)
              for k in ("qkv_cluster_kernel", "out_ring_kernel")]
    check(counts == [8, 2], f"bulk-copy kernel instantiations: {list(found)}")
    return found


def tc_bound_ms(nbytes, flops, dtype, passes=3):
    """The tensor-core bound of the attention kernels (K1 forward, K1c,
    K1d): f32 operands take ``passes`` TF32 passes at 495 TFLOP/s (three,
    hi.hi + hi.lo + lo.hi, under the full-f32 policy; one under the
    default), bf16 one pass at 989."""
    passes, rate = ((passes, TF32_FLOP_S) if dtype == "float32"
                    else (1, BF16_FLOP_S))
    b, f = nbytes / HBM_BYTES_S, passes * flops / rate
    return 1e3 * max(b, f), ("bytes" if b >= f else "operations")


def use_tc_bound(row, nbytes, flops, dtype, passes=3):
    """Make an attention kernel's row's ``bound_ms`` and ``bound_by``
    (those of the kernels line) the tensor-core bound, the rate these
    kernels multiply at, keep the f32-FMA bound beside it as
    ``fma_bound_ms``, and print both with the roofline share against
    each."""
    tms, tby = tc_bound_ms(nbytes, flops, dtype, passes)
    row["fma_bound_ms"], row["fma_bound_by"] = row["bound_ms"], row["bound_by"]
    row["bound_ms"], row["bound_by"] = tms, tby
    rate = (f"{passes} TF32 pass{'es' if passes > 1 else ''} at 495"
            if dtype == "float32" else "1 bf16 pass at 989")
    print(f"{row['name']} {row['case']}: bound_ms {tms:.6f} ({tby}, tensor "
          f"cores, {rate} TFLOP/s; the kernels line's bound_ms, roofline "
          f"share {tms / row['ms']:.3f}) f32-FMA bound "
          f"{row['fma_bound_ms']:.6f} ({row['fma_bound_by']}, 67 TFLOP/s; "
          f"roofline share {row['fma_bound_ms'] / row['ms']:.3f})",
          flush=True)


def measure(name, case, err, tol, kernel, plain, library, nbytes, flops,
            n_inputs=1, plain_iters=20, iters=100):
    """Check one kernel's error against its tolerance, time it, its plain
    version and (where there is one) the library call, and return the
    row of the kernels line (plus the case and the host time per call)."""
    check(err <= tol, f"{name} {case}: max err {err} > {tol}")
    ms, call_ms = time_ms(kernel, n_inputs, iters=iters)
    plain_ms, _ = time_ms(plain, n_inputs, iters=plain_iters)
    lib_ms = time_ms(library, n_inputs, iters=iters)[0] if library else None
    bms, by = bound_ms(nbytes, flops)
    lib_txt = "null" if lib_ms is None else f"{lib_ms:.5f}"
    print(f"{name} {case}: max_abs_err {err:.3e} (tol {tol:g}) ms {ms:.5f} "
          f"(host {call_ms:.5f} per call) plain_ms {plain_ms:.5f} "
          f"library_ms {lib_txt} bound_ms {bms:.6f} ({by})", flush=True)
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "case": case, "tol": tol,
            "host_ms_per_call": call_ms}


def int8_rows_diff(torch, got, want, what):
    """Hold K5a's int8 K/V rows (``got``, one tuple of (N, H, D+4)
    tensors) against the plain version's (``want``). Inputs are random,
    so the f32 sums of U products run in another order on each side:
    the amax, hence the scale, may differ in the last bit, and a value
    lying within that much of a half-way point may round one step
    apart. Scales must agree to 1e-5 relative, and at most 2 values may
    differ, by one step; a quantizer that truncates or rounds half away
    from zero differs on about half of them. Returns the largest
    difference of the dequantized rows and the counts of differing
    scales and values."""
    from mxnet_tpu_torch.ops import nn as tnn

    err, scales_off, values_off, total = 0.0, 0, 0, 0
    for g, w in zip(got, want):
        d = g.shape[-1] - 4
        sg = g[..., d:].contiguous().view(torch.float32)
        sw = w[..., d:].contiguous().view(torch.float32)
        check(((sg - sw).abs() <= 1e-5 * sw.abs()).all().item(),
              f"{what}: int8 scales differ by more than 1e-5 relative")
        steps = (g[..., :d].int() - w[..., :d].int()).abs()
        check(steps.max().item() <= 1, f"{what}: int8 values differ by "
              "more than one quantization step")
        scales_off += int((sg != sw).sum().item())
        values_off += int((steps > 0).sum().item())
        total += steps.numel()
        err = max(err, (tnn.kv_cache_dequantize(g, torch.float32)
                        - tnn.kv_cache_dequantize(w, torch.float32))
                  .abs().max().item())
    print(f"{what}: int8 K/V against the plain version, {scales_off} of "
          f"{total // d} scales one or more bits apart, {values_off} of "
          f"{total} values one step apart (limit 2)", flush=True)
    check(values_off <= 2, f"{what}: {values_off} int8 values differ")
    return err, scales_off, values_off


def qkv_rounding_probe(u, heads, n, seed=SEED):
    """K5a inputs whose int8 K/V rows are known exactly, built so that a
    quantizer that rounds wrongly shows.

    ``x`` is one-hot per token (``x[t, t] = 1``), so ``x . W^T + b``
    (``b = 0``) picks column ``t`` of ``W`` and every sum is exact in any
    order. The K and V columns hold, per (token, head), one value
    ``±amax`` and D-1 values ``(k + 1/2) * scale`` rounded to f32, with
    ``scale = amax * f32(1/127)`` as the quantizer computes it: ``y /
    scale`` then lands on a half-way point or one ulp beside it.
    Returns ``(x, w, b, q, kv_rows, wrong)``: the f32 inputs, the
    expected q (N, H, D), the expected (N, 2, H, D+4) int8 rows of K and
    V, and for each wrong rounding (truncation, a multiply by the
    reciprocal of the scale, half away from zero) the number of values
    on which it would differ from the expected rows."""
    rng = np.random.default_rng(seed)
    d = u // heads
    inv127 = np.float32(1) / np.float32(127)
    amax = rng.uniform(0.5, 4.0, (n, 2, heads, 1)).astype(np.float32)
    scale = amax * inv127
    halves = (rng.integers(-127, 127, (n, 2, heads, d)).astype(np.float32)
              + np.float32(0.5))
    vals = halves * scale
    top = rng.integers(0, d, (n, 2, heads, 1))
    sign = rng.choice(np.float32([-1, 1]), (n, 2, heads, 1))
    np.put_along_axis(vals, top, sign * amax, axis=-1)
    t = vals / scale
    expect = np.clip(np.rint(t), -127, 127)           # half to even
    wrong = {
        "truncating": np.trunc(t),
        "reciprocal-multiply": np.rint(vals * (np.float32(1) / scale)),
        "half-away-from-zero": np.sign(t) * np.floor(np.abs(t) + 0.5)}
    wrong = {k: int((np.clip(v, -127, 127) != expect).sum())
             for k, v in wrong.items()}
    rows = np.concatenate([expect.astype(np.int8), scale.view(np.int8)],
                          axis=-1)                    # little-endian bytes
    y = np.zeros((n, 3 * u), np.float32)
    y[:, :u] = rng.standard_normal((n, u))
    y[:, u:] = vals.reshape(n, 2 * u)
    x = np.zeros((n, u), np.float32)
    x[np.arange(n), np.arange(n)] = 1.0
    w = np.zeros((3 * u, u), np.float32)
    w[:, :n] = y.T
    return (x, w, np.zeros(3 * u, np.float32), y[:, :u].reshape(n, heads, d),
            rows, wrong)


def rounding_probe_check(torch, dev, u, heads, n):
    """K5a and its plain version on :func:`qkv_rounding_probe`'s inputs
    must give the expected rows byte for byte, and each wrong rounding
    must differ from them on at least 5% of the values, so that the probe
    would catch it."""
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd

    x, w, b, q, rows, wrong = qkv_rounding_probe(u, heads, n)
    nvals = rows[..., :-4].size
    for name, cnt in wrong.items():
        check(cnt >= 0.05 * nvals, f"rounding probe: a {name} quantizer "
              f"would differ on only {cnt} of {nvals} values")
    x, w, b = (torch.from_numpy(a).to(dev) for a in (x, w, b))
    q, rows = torch.from_numpy(q).to(dev), torch.from_numpy(rows).to(dev)
    for side, out in (
            ("kernel", kfd.fused_qkv_project(x, w, b, heads=heads,
                                             store_dtype=torch.int8)),
            ("plain", kfd.qkv_project_plain(x, w, b, heads, torch.int8))):
        check(torch.equal(out[0], q), f"rounding probe: {side} q differs")
        for i, c in enumerate(out[1:]):
            off = int((c != rows[:, i]).sum().item())
            check(off == 0, f"rounding probe: {side} {'KV'[i]} rows differ "
                  f"from the expected rows in {off} bytes")
    print(f"qkv_project rounding probe: kernel and plain int8 K/V rows "
          f"identical to the expected {rows.numel()} bytes; a quantizer "
          f"would differ on this many of {nvals} values: {wrong}",
          flush=True)


def launch_floor(torch):
    """The device time of a near-empty launch (``torch.cuda._sleep(1)``)
    by :func:`time_ms`: the floor that rows at decode shapes are read
    against. Not a kernel of the port."""
    ms = time_ms(lambda i: torch.cuda._sleep(1))[0]
    print(f"launch floor: torch.cuda._sleep(1) ms {ms:.5f}", flush=True)
    return ms


def kernel_checks(torch, dev, floor_ms):
    """Phase 2: every kernel against its plain version at full-width
    shapes. Returns every measured row; the first row of each kernel is
    its entry in the kernels line. ``floor_ms`` is the launch floor
    (:func:`launch_floor`), printed beside K2, K5a and K5b."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows = []
    u, heads, d, bs = 768, 12, 64, 16

    # K2: decode rows (8), the largest prefill bucket (1024) and the train
    # step (8192), each on the warp route; the block route beside it,
    # through its library entry, checked and timed in the same run -----
    lib = _build.load("layer_norm")

    def ln_block(x, gam, bet):
        with torch.cuda.device(x.device):
            out, err = kln.ln_launch(lib, "block", x, gam, bet, 1e-5,
                                     _build.stream_ptr(x.device))
        _build.check(err, "layer_norm_fwd block route")
        return out

    def ln_err(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want))

    for n in (8, 1024, 8192):
        x = randn(n, u, scale=2.0) + 0.5
        gam, bet = randn(u, scale=0.1) + 1.0, randn(u, scale=0.1)
        check(kln.ln_route(x, gam, bet) == "warp",
              f"layer_norm_fwd ({n}, {u}): not on the warp route")
        want = kln.layer_norm_plain(x, gam, bet, 1e-5)
        err = ln_err(kln.fused_layer_norm(x, gam, bet, 1e-5), want)
        block_err = ln_err(ln_block(x, gam, bet), want)
        # f32 sums of 768 terms in another order
        check(block_err <= 1e-5, f"layer_norm_fwd ({n}, {u}) block route: "
              f"max err {block_err}")
        row = measure(
            "layer_norm_fwd", f"({n}, {u}) f32", err, 1e-5,
            lambda i: kln.fused_layer_norm(x, gam, bet, 1e-5),
            lambda i: kln.layer_norm_plain(x, gam, bet, 1e-5),
            lambda i: F.layer_norm(x, (u,), gam, bet, 1e-5),
            4 * (2 * n * u + 2 * u + 2 * n), 8 * n * u)
        # in turns: warp (above), block, block, warp
        block_ms = [time_ms(lambda i: ln_block(x, gam, bet))[0]
                    for _ in range(2)]
        warp_ms = time_ms(lambda i: kln.fused_layer_norm(x, gam, bet,
                                                         1e-5))[0]
        row.update(block_ms=block_ms, warp_ms=[row["ms"], warp_ms],
                   block_err=block_err, launch_floor_ms=floor_ms)
        print(f"layer_norm_fwd ({n}, {u}) f32: warp route ms {row['ms']:.5f}, "
              f"{warp_ms:.5f}; block route ms {block_ms[0]:.5f}, "
              f"{block_ms[1]:.5f} (max_abs_err {block_err:.3e}); launch "
              f"floor {floor_ms:.5f}", flush=True)
        rows.append(row)
    # rows the warp route does not take: wider than 1024, or no multiple
    # of 16 bytes; through the wrapper, on the block route
    for d_ in (4096, 770):
        x = randn(8, d_, scale=2.0) + 0.5
        gam, bet = randn(d_, scale=0.1) + 1.0, randn(d_, scale=0.1)
        check(kln.ln_route(x, gam, bet) == "block",
              f"layer_norm_fwd (8, {d_}): not on the block route")
        err = ln_err(kln.fused_layer_norm(x, gam, bet, 1e-5),
                     kln.layer_norm_plain(x, gam, bet, 1e-5))
        print(f"layer_norm_fwd (8, {d_}) f32, block route: max_abs_err "
              f"{err:.3e} (tol 1e-5)", flush=True)
        check(err <= 1e-5, f"layer_norm_fwd (8, {d_}): max err {err}")
        rows.append({"name": "layer_norm_fwd", "case": f"(8, {d_}) f32 block "
                     "route", "max_abs_err": err, "tol": 1e-5})

    # K4: 8 lanes, lengths spread over 1..2048, and the decode step's
    # mid-decode lengths (the served batch's prompts + 16) ---------------
    r, mb = 8, 128
    nb = r * mb + 1
    perm = torch.randperm(r * mb, generator=g, device=dev)
    table = perm.reshape(r, mb).to(torch.int32).contiguous()
    q = randn(r, heads, d)
    for name, lens in (("lengths", [1, 17, 256, 511, 1000, 1500, 2047, 2048]),
                       ("mid-decode lengths", mid_decode_lengths())):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        live = int(lengths.sum().item())
        blocks = int(((lengths + bs - 1) // bs).sum().item())
        for kind in ("int8", "float32"):
            n_sets = 4 if kind == "int8" else 2     # > 50 MB of pools cycled
            pools = []
            for _ in range(n_sets):
                kp, vp = randn(nb, heads, bs, d), randn(nb, heads, bs, d)
                if kind == "int8":
                    kp = tnn.kv_cache_quantize(kp)
                    vp = tnn.kv_cache_quantize(vp)
                pools.append((kp.contiguous(), vp.contiguous()))
            kp, vp = pools[0]
            out = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
            ref = kpa.paged_attention_plain(q, kp, vp, table, lengths)
            check(torch.isfinite(out).all().item(),
                  f"paged_attention {kind}: non-finite output")
            # no atomics on the values: a second run gives the same bits
            again = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
            check(torch.equal(out, again),
                  f"paged_attention {kind} {name}: two runs differ")
            row_bytes = kp.shape[-1] * kp.element_size()
            # live K and V rows once, q, out, the live table entries,
            # lengths
            nbytes = (2 * live * heads * row_bytes + 2 * r * heads * d * 4
                      + 4 * blocks + 4 * r)
            rows.append(measure(
                "paged_attention",
                f"R{r} H{heads} D{d} bs{bs} MB{mb} {kind} pools, {name} "
                f"{lens}", (out - ref).abs().max().item(),
                # each span's exact softmax merged with the others against
                # one softmax over all positions: f32 sums in another order
                1e-4,
                lambda i: kpa.paged_attention_kernel(
                    q, pools[i][0], pools[i][1], table, lengths),
                lambda i: kpa.paged_attention_plain(
                    q, pools[i][0], pools[i][1], table, lengths),
                None, nbytes, 4 * live * heads * d, n_inputs=n_sets))
            check(rows[-1]["ms"] < rows[-1]["plain_ms"],
                  f"paged_attention {kind} {name}: kernel {rows[-1]['ms']} "
                  f"ms not under its plain version {rows[-1]['plain_ms']}")
            del pools

    # K5a / K5b: 8 decode tokens, one weight set per layer ----------------
    n, n_sets = 8, 12
    cl = {str(dt)[6:]: kfd.qkv_cluster(u, heads, dt)
          for dt in (torch.float32, torch.bfloat16)}
    print(f"qkv_project: cluster size at U {u} H {heads} (0: the head "
          f"route) {cl}", flush=True)
    check(all(c > 0 for c in cl.values()), f"qkv_project: U {u} H {heads} "
          f"not on the cluster route: {cl}")
    x = randn(n, u)
    wq = [randn(3 * u, u, scale=0.02) for _ in range(n_sets)]
    bq = [randn(3 * u, scale=0.02) for _ in range(n_sets)]
    q5, k5, v5 = kfd.fused_qkv_project(x, wq[0], bq[0], heads=heads,
                                       store_dtype=torch.int8)
    # fixed-order sums and an order-free amax: a second run, the same bits
    again = kfd.fused_qkv_project(x, wq[0], bq[0], heads=heads,
                                  store_dtype=torch.int8)
    check(all(torch.equal(a_, b_) for a_, b_ in zip((q5, k5, v5), again)),
          "qkv_project: two runs differ")
    pq, pk, pv = kfd.qkv_project_plain(x, wq[0], bq[0], heads, torch.int8)
    q_err = (q5 - pq).abs().max().item()
    check(q_err <= 1e-4, f"qkv_project: q differs by {q_err}")
    err, scales_off, values_off = int8_rows_diff(torch, (k5, v5), (pk, pv),
                                                 "qkv_project f32")
    err = max(err, q_err)
    rounding_probe_check(torch, dev, u, heads, n)
    rows.append(measure(
        "qkv_project", f"N{n} U{u} H{heads} int8 store", err,
        # q: f32 sums of 768 terms in another order; int8 K/V may flip a
        # near-tie rounding, one step = the scale, about 0.02 here
        0.05,
        lambda i: kfd.fused_qkv_project(x, wq[i], bq[i], heads=heads,
                                        store_dtype=torch.int8),
        lambda i: kfd.qkv_project_plain(x, wq[i], bq[i], heads, torch.int8),
        # the Q, K and V product alone (no int8 store), as at phase 10's N
        lambda i: F.linear(x, wq[i], bq[i]),
        4 * (3 * u * u + 3 * u + 2 * n * u) + 2 * n * heads * (d + 4),
        2 * n * 3 * u * u, n_inputs=n_sets))
    rows[-1].update(cluster=cl["float32"], launch_floor_ms=floor_ms,
                    two_runs_bitwise=True)
    print(f"qkv_project N{n} U{u}: cluster {cl['float32']}, ms "
          f"{rows[-1]['ms']:.5f} against its bound {rows[-1]['bound_ms']:.6f} "
          f"and the launch floor {floor_ms:.5f}; two runs bitwise equal",
          flush=True)
    del wq, bq
    # N 20: three token chunks, the last one ragged; then a width whose
    # slab does not fit a cluster (U 4096, D 128: the head route). Inputs
    # are small multiples of 1/4 and 1/64, so every sum is exact in f32
    # in any order and the kernel's q and int8 K/V rows must equal the
    # plain version's byte for byte
    def dyadic(*shape, denom):
        return torch.randint(-4, 5, shape, generator=g, device=dev) / denom

    for n_, u_, h_ in ((20, u, heads), (8, 4096, 32)):
        xx, ww, bb = (dyadic(n_, u_, denom=4), dyadic(3 * u_, u_, denom=64),
                      dyadic(3 * u_, denom=4))
        c_ = kfd.qkv_cluster(u_, h_, torch.float32)
        check((c_ > 0) == (u_ == u), f"qkv_project U {u_}: cluster {c_}")
        got = kfd.fused_qkv_project(xx, ww, bb, heads=h_,
                                    store_dtype=torch.int8)
        want = kfd.qkv_project_plain(xx, ww, bb, h_, torch.int8)
        case = (f"N{n_} U{u_} H{h_} int8 store, dyadic inputs, "
                + (f"cluster {c_}" if c_ else "head route"))
        off = [int((a_ != b_).sum().item()) for a_, b_ in zip(got, want)]
        print(f"qkv_project {case}: q, K and V rows differing from the "
              f"plain version in {off} elements (must be 0)", flush=True)
        check(off == [0, 0, 0], f"qkv_project {case}: {off} elements differ")
        rows.append({"name": "qkv_project", "case": case, "max_abs_err": 0.0,
                     "elements_off": off})
        del xx, ww, bb, got, want

    # K5b: the ring route at the decode step's shape, W cold in L2 ------
    geo = {str(dt)[6:]: kfd.out_geometry(u, u, dt)
           for dt in (torch.float32, torch.bfloat16)}
    print(f"out_project: geometry at U {u}: {geo}", flush=True)
    check(all(g_["route"] == "ring" and not g_["walks"]
              for g_ in geo.values()),
          f"out_project U {u}: not on the ring route with its slab resident")
    a = randn(n, u)
    wo = [randn(u, u, scale=0.02) for _ in range(n_sets)]
    bo = [randn(u, scale=0.02) for _ in range(n_sets)]
    o5 = kfd.fused_out_project(a, wo[0], bo[0])
    # fixed-order sums: a second run, the same bits
    check(torch.equal(o5, kfd.fused_out_project(a, wo[0], bo[0])),
          "out_project: two runs differ")
    err = (o5 - kfd.out_project_plain(a, wo[0], bo[0])).abs().max().item()
    rows.append(measure(
        # f32 sums of 768 terms in another order
        "out_project", f"N{n} U{u}", err, 1e-4,
        lambda i: kfd.fused_out_project(a, wo[i], bo[i]),
        lambda i: kfd.out_project_plain(a, wo[i], bo[i]),
        lambda i: F.linear(a, wo[i], bo[i]),
        4 * (u * u + u + 2 * n * u), 2 * n * u * u, n_inputs=n_sets))
    row = rows[-1]
    row.update(geometry=geo["float32"], launch_floor_ms=floor_ms,
               two_runs_bitwise=True)
    print(f"out_project N{n} U{u} f32, cold W: ms {row['ms']:.5f} against "
          f"its bound {row['bound_ms']:.6f}, the launch floor "
          f"{floor_ms:.5f}, F.linear {row['library_ms']:.5f} "
          f"({row['library_ms'] / row['ms']:.2f}x the kernel's time); "
          "two runs bitwise equal", flush=True)
    del wo, bo
    # exact (dyadic) inputs, byte for byte against the plain version: 20
    # tokens (three chunks), a U_out no block size divides, U 4096 f32
    # (its rows just fit beside the activations), a width whose rows the
    # ring walks (U_in 4608 f32), bfloat16, and a width on the row route
    # (U_in 8192 f32)
    for n_, ui, uo, dt, route in (
            (20, u, u, torch.float32, "resident"),
            (n, u, 769, torch.float32, "resident"),
            (n, 4096, 4096, torch.float32, "resident"),
            (20, 4608, u, torch.float32, "walks"),
            (n, u, u, torch.bfloat16, "resident"),
            (n, 8192, u, torch.float32, "row")):
        g_ = kfd.out_geometry(ui, uo, dt)
        got_route = ("row" if g_["route"] == "row"
                     else "walks" if g_["walks"] else "resident")
        case = (f"N{n_} U_in {ui} U_out {uo} {str(dt)[6:]}, dyadic inputs, "
                f"{got_route} (rows {g_['rows']}, stages {g_['stages']}, "
                f"slots {g_['slots']}, blocks {g_['blocks']})")
        check(got_route == route, f"out_project {case}: expected {route}")
        aa = dyadic(n_, ui, denom=4).to(dt)
        ww, bb = dyadic(uo, ui, denom=64).to(dt), dyadic(uo, denom=4).to(dt)
        off = int((kfd.fused_out_project(aa, ww, bb)
                   != kfd.out_project_plain(aa, ww, bb)).sum().item())
        print(f"out_project {case}: {off} elements differing from the plain "
              "version (must be 0)", flush=True)
        check(off == 0, f"out_project {case}: {off} elements differ")
        rows.append({"name": "out_project", "case": case, "max_abs_err": 0.0,
                     "elements_off": off})
        del aa, ww, bb
    return rows


def mid_decode_lengths():
    """The served batch's lengths halfway through its 32 new tokens (the
    decode step of phases 4 and 5): phase 3 draws the 8 prompt lengths
    first from this generator."""
    prompt_lens = np.random.default_rng(SEED + 1).integers(16, 1025, size=8)
    return [int(n) + NEW_TOKENS // 2 for n in prompt_lens]


def paged_edge_checks(torch, dev):
    """K4 once at the edges of its split, against its plain version at
    1e-4, each run twice for bitwise-equal results: lengths span - 1,
    span and span + 1 positions (one span, and a second span of one
    position), MB * bs, one above MB * bs (capped, as on the TPU), and a
    batch of one lane; int8 and f32 pools. Then once on each path of the
    kernel that the main path's shapes do not take. Returns one row per
    case."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    heads, d, bs, mb = 12, 64, 16, 128
    rows = []
    span_blocks = kpa._span(_build.load("paged_attention"))
    span = span_blocks * bs
    r = 6
    lens_all = [span - 1, span, span + 1, mb * bs, mb * bs + 1, 1]
    table = (torch.randperm(r * mb, generator=g, device=dev)
             .reshape(r, mb).to(torch.int32).contiguous())
    q = torch.randn(r, heads, d, generator=g, device=dev)
    for kind in ("int8", "float32"):
        kp, vp = (torch.randn(r * mb + 1, heads, bs, d, generator=g,
                              device=dev) for _ in range(2))
        if kind == "int8":
            kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
        for case, (qq, tt, ll) in (
                (f"lengths {lens_all}", (q, table, lens_all)),
                ("one lane, length 1000", (q[:1], table[:1], [1000]))):
            lengths = torch.tensor(ll, dtype=torch.int32, device=dev)
            out = kpa.paged_attention_kernel(qq, kp, vp, tt, lengths)
            again = kpa.paged_attention_kernel(qq, kp, vp, tt, lengths)
            ref = kpa.paged_attention_plain(qq, kp, vp, tt, lengths)
            err = (out - ref).abs().max().item()
            print(f"paged_attention {kind} pools, span {span} positions, "
                  f"{case}: max_abs_err {err:.3e} (tol 1e-4), two runs "
                  f"bitwise equal {torch.equal(out, again)}", flush=True)
            check(torch.isfinite(out).all().item() and err <= 1e-4,
                  f"paged_attention {kind} {case}: {err}")
            check(torch.equal(out, again),
                  f"paged_attention {kind} {case}: two runs differ")
            rows.append({"name": "paged_attention", "case": f"{kind} pools, "
                         f"span {span}, {case}", "max_abs_err": err,
                         "tol": 1e-4})
    # the kernel's other paths: slices staged by plain loads (no multiple
    # of 16 bytes), 4 and 8 features a lane (D 128, 256), one slice per
    # ring stage, over 48 KB of shared memory (64 KB slices); tolerances
    # as variant_checks' (the plain version rounds weights to the pool's
    # dtype)
    f32, bf16, f16, i8 = (torch.float32, torch.bfloat16, torch.float16,
                          torch.int8)
    for q_dt, p_dt, d, bs, tol in ((f32, i8, 64, 1, 1e-4),
                                   (bf16, i8, 128, 8, 3e-2),
                                   (f32, f32, 256, 16, 1e-4),
                                   (f32, f16, 33, 3, 1e-2),
                                   (bf16, bf16, 256, 128, 3e-2)):
        r, mb = 3, max(2, 1024 // bs)
        lens = [1, span_blocks * bs + 1, mb * bs]
        table = (torch.randperm(r * mb, generator=g, device=dev)
                 .reshape(r, mb).to(torch.int32).contiguous())
        q = torch.randn(r, heads, d, generator=g, device=dev).to(q_dt)
        kp, vp = (torch.randn(r * mb + 1, heads, bs, d, generator=g,
                              device=dev) for _ in range(2))
        if p_dt == i8:
            kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
        else:
            kp, vp = kp.to(p_dt), vp.to(p_dt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
        again = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
        ref = kpa.paged_attention_plain(q, kp, vp, table, lengths)
        err = (out.float() - ref.float()).abs().max().item()
        case = (f"q {str(q_dt)[6:]} pools {str(p_dt)[6:]} D{d} bs{bs} MB{mb} "
                f"lengths {lens}")
        print(f"paged_attention {case}: max_abs_err {err:.3e} (tol {tol:g}), "
              f"two runs bitwise equal {torch.equal(out, again)}", flush=True)
        check(out.dtype == ref.dtype and torch.isfinite(out).all().item()
              and err <= tol, f"paged_attention {case}: {err}")
        check(torch.equal(out, again), f"paged_attention {case}: two runs "
              "differ")
        rows.append({"name": "paged_attention", "case": case,
                     "max_abs_err": err, "tol": tol})
    return rows


def variant_checks(torch, dev):
    """Phase 2, the other dtype variants: every combination of dtypes the
    wrappers launch, besides the float32 ones timed above, once against
    its plain version at the main path's shapes. A bfloat16 model or
    ``kv_cache_dtype="bfloat16"|"float16"`` reaches them. Returns one
    row per variant."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    f32, bf16, f16, i8 = (torch.float32, torch.bfloat16, torch.float16,
                          torch.int8)
    # (atol, rtol) of an output that both sides compute in f32 and round
    # once to its dtype: after sums in another order the f32 values may
    # lie on either side of a rounding point, one ulp apart (2^-7 of the
    # value in bfloat16, 2^-10 in float16)
    once = {f32: (1e-4, 0.0), bf16: (1e-5, 2.0 ** -7),
            f16: (1e-5, 2.0 ** -10)}
    # K4's plain version also rounds the softmax weights to the dtype it
    # attends in (and, attending in bfloat16, the scores), where the
    # kernel keeps f32: each weight within 2^-8 (bfloat16) or 2^-11
    # (float16) of the kernel's, so the output within that share of
    # max |v| (about 5 here: 0.02 and 0.0025), plus the output's own
    # rounding; the bfloat16 limit is the CPU tests' 3e-2
    attend = {f32: (1e-4, 0.0), bf16: (3e-2, 0.0), f16: (1e-2, 0.0)}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    out = []

    def hold(kernel, case, got, want, tol):
        gf, wf = got.float(), want.float()
        diff = (gf - wf).abs()
        check(torch.isfinite(gf).all().item(), f"{kernel} {case}: non-finite")
        err = diff.max().item()
        ratio = (diff / (tol[0] + tol[1] * wf.abs())).max().item()
        print(f"{kernel} {case}: max_abs_err {err:.3e}, worst |err| / "
              f"({tol[0]:g} + {tol[1]:g} |ref|) = {ratio:.3f} (limit 1)",
              flush=True)
        check(ratio <= 1.0, f"{kernel} {case}: max err {err} outside "
              f"atol {tol[0]} rtol {tol[1]}")
        out.append({"name": kernel, "case": case, "max_abs_err": err,
                    "atol": tol[0], "rtol": tol[1]})

    u, heads, d, bs = 768, 12, 64, 16
    # K2 in bfloat16: y rounded once, statistics in f32 -------------------
    for n in (8, 1024):
        x = randn(n, u, scale=2.0, dtype=bf16) + 0.5
        gam = randn(u, scale=0.1, dtype=bf16) + 1.0
        bet = randn(u, scale=0.1, dtype=bf16)
        y, mean, rstd = kln.fused_layer_norm(x, gam, bet, 1e-5)
        py, pmean, prstd = kln.layer_norm_plain(x, gam, bet, 1e-5)
        check(y.dtype == py.dtype == bf16, "layer_norm_fwd bf16: dtype")
        hold("layer_norm_fwd", f"({n}, {u}) bf16 y", y, py, once[bf16])
        hold("layer_norm_fwd", f"({n}, {u}) bf16 mean, rstd",
             torch.cat([mean, rstd]), torch.cat([pmean, prstd]), (1e-5, 0.0))

    # K4: q float32 / bfloat16 x pools int8 / float32 / bfloat16 / float16
    r, mb = 8, 128
    lengths = torch.tensor([1, 17, 256, 511, 1000, 1500, 2047, 2048],
                           dtype=torch.int32, device=dev)
    table = (torch.randperm(r * mb, generator=g, device=dev)
             .reshape(r, mb).to(torch.int32).contiguous())
    for q_dt in (f32, bf16):
        q = randn(r, heads, d, dtype=q_dt)
        for p_dt in (i8, f32, bf16, f16):
            if (q_dt, p_dt) in ((f32, i8), (f32, f32)):
                continue                        # timed and held above
            kp, vp = (randn(r * mb + 1, heads, bs, d) for _ in range(2))
            if p_dt == i8:
                kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
            else:
                kp, vp = kp.to(p_dt), vp.to(p_dt)
            got = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
            want = kpa.paged_attention_plain(q, kp, vp, table, lengths)
            check(got.dtype == want.dtype, f"paged_attention q {q_dt} "
                  f"pools {p_dt}: dtype {got.dtype} != {want.dtype}")
            hold("paged_attention", f"q {str(q_dt)[6:]} pools "
                 f"{str(p_dt)[6:]} R{r} H{heads} D{d} bs{bs} MB{mb}",
                 got, want, attend[want.dtype])
    del kp, vp

    # K5a: x float32 / bfloat16 x store int8 / float32 / bfloat16 / float16
    n = 8
    for x_dt in (f32, bf16):
        x = randn(n, u, dtype=x_dt)
        w = randn(3 * u, u, scale=0.02, dtype=x_dt)
        b = randn(3 * u, scale=0.02, dtype=x_dt)
        for s_dt in (i8, f32, bf16, f16):
            if (x_dt, s_dt) == (f32, i8):
                continue                        # timed and held above
            case = f"N{n} U{u} H{heads} x {str(x_dt)[6:]} store " \
                   f"{str(s_dt)[6:]}"
            got = kfd.fused_qkv_project(x, w, b, heads=heads,
                                        store_dtype=s_dt)
            want = kfd.qkv_project_plain(x, w, b, heads, s_dt)
            for gt, wt in zip(got, want):
                check(gt.dtype == wt.dtype and gt.shape == wt.shape,
                      f"qkv_project {case}: {gt.dtype} {tuple(gt.shape)} "
                      f"!= {wt.dtype} {tuple(wt.shape)}")
            hold("qkv_project", case + " q", got[0], want[0], once[x_dt])
            if s_dt == i8:
                err, scales_off, values_off = int8_rows_diff(
                    torch, got[1:], want[1:], f"qkv_project {case}")
                out.append({"name": "qkv_project", "case": case + " k, v",
                            "max_abs_err": err, "scales_off": scales_off,
                            "values_off": values_off})
            else:
                hold("qkv_project", case + " k, v", torch.cat(got[1:]),
                     torch.cat(want[1:]), once[s_dt])

    # K5b in bfloat16 ------------------------------------------------------
    a = randn(n, u, dtype=bf16)
    w = randn(u, u, scale=0.02, dtype=bf16)
    b = randn(u, scale=0.02, dtype=bf16)
    hold("out_project", f"N{n} U{u} bf16",
         kfd.fused_out_project(a, w, b), kfd.out_project_plain(a, w, b),
         once[bf16])
    return out


def live_pairs(lq, lk, causal):
    """(query, key) pairs attention counts: all of them, or those under
    the bottom-right causal mask k <= q + (lk - lq)."""
    if not causal:
        return lq * lk
    return sum(min(lk, max(0, q + lk - lq + 1)) for q in range(lq))


def attention_cost(b, h, lq, lk, d, causal, itemsize):
    """Bytes and f32 operations of the three attention kernels at one
    shape: every input read once and every output written once, and 2
    operations per multiply-add over the live pairs (2 products
    forward, 3 for dQ, 4 for dK/dV)."""
    pairs = b * h * live_pairs(lq, lk, causal)
    q_t, kv_t = b * h * lq * d * itemsize, b * h * lk * d * itemsize
    vec = 4 * b * h * lq                      # lse or D, f32
    return {"fwd": (q_t + 2 * kv_t + q_t + vec, 4 * d * pairs),
            "dq": (3 * q_t + 2 * kv_t + vec + q_t + vec, 6 * d * pairs),
            "dkv": (2 * q_t + 2 * kv_t + 2 * vec + 2 * kv_t, 8 * d * pairs)}


def flash_case(torch, kfa, q, k, v, go, causal, policy="highest",
               round_tf32=False):
    """K1 forward, K1c and K1d under the matmul ``policy`` and their plain
    versions on one input set, each kernel fed the kernel's own upstream
    results and each plain version the same. The plain versions run in
    IEEE f32, their operands rounded to TF32 with ``round_tf32``.
    Returns {part: (errors, max |ref|)}."""
    from mxnet_tpu_torch.base import matmul_precision_scope

    with torch.no_grad():
        with matmul_precision_scope(policy):
            out, lse = kfa.flash_forward(q, k, v, causal)
            dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, causal)
            dk, dv = kfa.flash_backward_dkv(q, k, v, go, lse, delta, causal)
        with matmul_precision_scope("highest"):
            pout, plse = kfa.flash_forward_plain(q, k, v, causal,
                                                 round_tf32=round_tf32)
            pdq, pdelta = kfa.flash_backward_dq_plain(
                q, k, v, out, lse, go, causal, round_tf32=round_tf32)
            pdk, pdv = kfa.flash_backward_dkv_plain(
                q, k, v, go, lse, delta, causal, round_tf32=round_tf32)
    live = plse > -1e29                   # rows that see a key
    res = {}
    for part, pairs in (("out", ((out, pout),)),
                        ("lse", ((lse[live], plse[live]),)),
                        ("dq", ((dq, pdq), (delta, pdelta))),
                        ("dkv", ((dk, pdk), (dv, pdv)))):
        errs = [(a.float() - b.float()).abs().max().item() for a, b in pairs]
        scale = max(b.float().abs().max().item() for _, b in pairs)
        check(all(torch.isfinite(a).all().item() for a, _ in pairs),
              f"flash {part}: non-finite")
        res[part] = (max(errs), scale)
    return res


# Tolerances of the attention kernels against their plain versions, as a
# share of the reference's largest magnitude. f32: sums of up to 1024
# terms in another order (and an online against a two-pass softmax),
# about 1e-6 of the magnitude; 1e-5 leaves ten times that. bf16: p and
# ds are rounded to bf16 (2^-8 relative) at another scale (the running
# against the final max), and the outputs once more: 2^-5 of the largest
# value, four bf16 steps of it.
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


# K3's rows (phases 2 and 16). Inputs under twice the H100's 50 MB L2 are
# cycled over as many input sets as make twice the L2 (at most
# K3_MAX_SETS), and each timed loop runs at least one call per set, so
# that the kernel reads its logits from device memory as a train step
# does. K3_MAX_SETS sets of an input under about 100 KB stay under twice
# the L2, and those of one under about 50 KB fit in it: their rows print
# as partly L2-resident or as L2-resident (launch-bound at such sizes).
# K3_TOL: an lse of V exponentials summed in another order, a few f32
# ulps of values near 12
L2_BYTES = 50 * 2 ** 20
K3_MAX_SETS = 1024
K3_TOL = 1e-5


def k3_sets(torch, randn, n, v, dtype, first=None):
    """(sets, n, v) input sets of ``dtype``: ``first`` (or a draw) and
    draws of ``randn(*shape)``, as many sets as :data:`K3_MAX_SETS` and
    twice the L2 allow."""
    size = torch.empty((), dtype=dtype).element_size()
    sets = max(1, min(K3_MAX_SETS, -(-2 * L2_BYTES // (n * v * size))))
    xs = (randn(sets, n, v) * 2.0).to(dtype)
    if first is not None:
        xs[0].copy_(first)
    return xs


def k3_residence(data):
    """How much of ``data`` bytes of input sets a timed loop finds in the
    L2, as a row's label."""
    if data < L2_BYTES:
        return " (L2-resident: every set fits in the L2)"
    if data < 2 * L2_BYTES:
        return " (partly L2-resident: under twice the L2)"
    return ""


def k3_direct(torch, x, route):
    """K3's kernel of ``route`` on x (the first design, "block", or a
    route lse_route does not give x), for comparison: not a launch of
    the wrapper, whose count does not move."""
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    lse = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = kce.lse_launch(_build.load("cross_entropy"), route, x, lse,
                             _build.stream_ptr(x.device))
    _build.check(err, f"cross_entropy_lse {route} route")
    return lse


def k3_case(torch, xs, case, route, labels=None, resident=False):
    """K3 on the input sets ``xs`` (sets, N, V): ``lse_route`` must give
    ``route``; fused_lse and the first design ("block") against lse_plain
    at K3_TOL on set 0, and cross_entropy_with_logits against the
    no_kernels loss where ``labels`` are given. Then timed over the sets
    beside its byte bound, lse_plain and torch.logsumexp (in bf16 it
    returns bf16), and in turns with the block route (route, block,
    block, route); a row on the warp route also times the wide route,
    which would take it past the rows route's cut. ``resident``: the
    three times again on set 0 alone, which stays in L2 where it fits.
    Returns the row."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    sets, n, v = xs.shape
    x = xs[0]
    dt = str(x.dtype)[6:]
    got_route = kce.lse_route(x)
    check(got_route == route, f"cross_entropy_lse ({n}, {v}) {dt}: route "
          f"{got_route}, expected {route}")
    want = kce.lse_plain(x)
    err = (kce.fused_lse(x) - want).abs().max().item()
    block_err = (k3_direct(torch, x, "block") - want).abs().max().item()
    check(block_err <= K3_TOL, f"cross_entropy_lse ({n}, {v}) {dt} block "
          f"route: max err {block_err}")
    if labels is not None:
        with tnn.no_kernels():
            pnll = tnn.softmax_cross_entropy(x, labels, per_example=True)
        err = max(err, (kce.cross_entropy_with_logits(x, labels) - pnll
                        ).abs().max().item())
    size = x.element_size()
    iters = max(100, sets)
    row = measure(
        "cross_entropy_lse", case, err, K3_TOL, lambda i: kce.fused_lse(xs[i]),
        lambda i: kce.lse_plain(xs[i]), lambda i: torch.logsumexp(xs[i], -1),
        size * n * v + 4 * n, 4 * n * v, n_inputs=sets, iters=iters)
    block_ms = [time_ms(lambda i: k3_direct(torch, xs[i], "block"), sets,
                        iters)[0] for _ in range(2)]
    again = time_ms(lambda i: kce.fused_lse(xs[i]), sets, iters)[0]
    data = sets * n * v * size
    row.update(k3_route=route, route_ms=[row["ms"], again], block_ms=block_ms,
               block_err=block_err, n_inputs=sets, data_mb=data / 1e6,
               l2_resident_sets=data < 2 * L2_BYTES)
    wide = ""
    if route == "warp":
        wide_err = (k3_direct(torch, x, "wide") - want).abs().max().item()
        check(wide_err <= K3_TOL, f"cross_entropy_lse ({n}, {v}) {dt} wide "
              f"route: max err {wide_err}")
        row["wide_ms"] = [time_ms(lambda i: k3_direct(torch, xs[i], "wide"),
                                  sets, iters)[0] for _ in range(2)]
        wide = (f"; wide route ms {row['wide_ms'][0]:.5f}, "
                f"{row['wide_ms'][1]:.5f} (max_abs_err {wide_err:.3e})")
    print(f"cross_entropy_lse {case}: route {route} ms {row['ms']:.5f}, "
          f"{again:.5f}; block route ms {block_ms[0]:.5f}, {block_ms[1]:.5f} "
          f"(max_abs_err {block_err:.3e}){wide}; torch.logsumexp "
          f"{row['library_ms']:.5f}; bound {row['bound_ms']:.6f}, roofline "
          f"share {row['bound_ms'] / min(row['ms'], again):.3f}; {sets} input "
          f"set(s), {data / 1e6:.1f} MB cycled{k3_residence(data)}",
          flush=True)
    if resident:
        res = {"ms": time_ms(lambda i: kce.fused_lse(x))[0],
               "block_ms": time_ms(lambda i: k3_direct(torch, x, "block"))[0],
               "library_ms": time_ms(lambda i: torch.logsumexp(x, -1))[0]}
        row["l2_resident"] = res
        print(f"cross_entropy_lse {case}, L2-resident (set 0 alone, "
              f"{n * v * size / 1e6:.1f} MB, called again and again): route "
              f"{route} ms {res['ms']:.5f}, block route ms "
              f"{res['block_ms']:.5f}, torch.logsumexp "
              f"{res['library_ms']:.5f}", flush=True)
    return row


def k3_beats_library(row):
    """A narrow-row K3 row must beat torch.logsumexp on the same inputs."""
    check(row["ms"] < row["library_ms"],
          f"cross_entropy_lse {row['case']}: {row['ms']} ms not under "
          f"torch.logsumexp's {row['library_ms']}")


def k3_keeps_pace(row):
    """A long-row K3 row must be no slower than the first design in the
    same call: its faster timing against the block route's faster one,
    with 1% for the spread between two loops of one kernel (up to 0.1%
    on the H100)."""
    ms, block = min(row["route_ms"]), min(row["block_ms"])
    check(ms <= 1.01 * block, f"cross_entropy_lse {row['case']}: route "
          f"{row['k3_route']} {ms} ms slower than the block route's {block}")


def k3_offset(torch, x, case):
    """The same logits at x's 16-byte-aligned address and 4 bytes past
    one: fused_lse must agree with itself and with lse_plain to K3_TOL.
    Returns the case's record."""
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    check(x.data_ptr() % 16 == 0, f"{case}: x not 16-byte aligned")
    skip = 4 // x.element_size()
    buf = torch.empty(x.numel() + skip, dtype=x.dtype, device=x.device)
    y = buf[skip:].view(x.shape)
    y.copy_(x)
    a, b = kce.fused_lse(x), kce.fused_lse(y)
    off = (b - a).abs().max().item()
    err = (b - kce.lse_plain(y)).abs().max().item()
    route = kce.lse_route(y)
    print(f"cross_entropy_lse {case}, route {route}, 4 bytes past a 16-byte "
          f"boundary: against the aligned copy {off:.3e}, against lse_plain "
          f"{err:.3e} (limit {K3_TOL:g})", flush=True)
    check(off <= K3_TOL and err <= K3_TOL,
          f"cross_entropy_lse {case} at a 4-byte offset: {off}, {err}")
    return {"name": "cross_entropy_lse", "case": f"{case}, 4-byte offset",
            "k3_route": route, "max_abs_err": max(off, err), "limit": K3_TOL}


def k3_train_rows(torch, dev, g):
    """Phase 2's K3 rows: the LM head's (8184, 32000) logits in f32 (the
    kernels line's row; about 5% of labels -1) and bf16, ResNet-50's
    (32, 1000) f32 and bf16, the example's resnet18_v1 head's (64, 10)
    f32 and bf16 (phase 17) and SSD300's class loss's (279424, 21) f32
    (cold and L2-resident) and bf16, random logits from ``g``; and the
    4-byte offset on each route. The LM head's f32 row must keep pace
    with the first design, SSD300's beat torch.logsumexp. Returns (rows,
    cases)."""
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rows, cases = [], []
    n, vocab = 8 * 1023, 32000
    xs = k3_sets(torch, randn, n, vocab, torch.float32)
    labels = torch.randint(0, vocab, (n,), generator=g, device=dev)
    labels[torch.rand(n, generator=g, device=dev) < 0.05] = -1
    nll = kce.cross_entropy_with_logits(xs[0], labels)
    ignored = labels < 0
    check(bool((nll[ignored] == 0).all().item()), "K3: ignored rows not 0")
    print(f"cross_entropy_with_logits ({n}, {vocab}) f32: "
          f"{int(ignored.sum().item())} labels -1, their nll 0", flush=True)
    rows.append(k3_case(torch, xs, f"({n}, {vocab}) f32", "wide", labels))
    k3_keeps_pace(rows[-1])
    cases.append(k3_offset(torch, xs[0], f"({n}, {vocab}) f32"))
    xs = xs.bfloat16()
    rows.append(k3_case(torch, xs, f"({n}, {vocab}) bf16", "wide"))
    del xs
    # ResNet-50's train step (phase 9), the example's resnet18_v1 head
    # (phase 17), and SSD300's class loss (phase 16)
    for (n, vocab), route, resident in (
            ((32, 1000), "wide", False), ((64, 10), "warp", False),
            ((DET_B * DET_ANCHORS, DET_CLASSES + 1), "rows", True)):
        xs = k3_sets(torch, randn, n, vocab, torch.float32)
        labels = torch.randint(0, vocab, (n,), generator=g, device=dev)
        rows.append(k3_case(torch, xs, f"({n}, {vocab}) f32", route, labels,
                            resident))
        if route == "rows":
            k3_beats_library(rows[-1])
        cases.append(k3_offset(torch, xs[0], f"({n}, {vocab}) f32"))
        xb = k3_sets(torch, randn, n, vocab, torch.bfloat16, xs[0])
        rows.append(k3_case(torch, xb, f"({n}, {vocab}) bf16", route))
        cases.append(k3_offset(torch, xb[0], f"({n}, {vocab}) bf16"))
        del xs, xb
    return rows, cases


def train_kernel_checks(torch, dev):
    """Phase 2, the training slice's kernels. K1 forward, K1c and K1d at
    the train step's (8, 12, 1024, 64) causal f32 and K3 at its
    (8184, 32000) f32 logits against their plain versions, timed, with
    SDPA and torch.logsumexp as library yardsticks, the three attention
    kernels also against their tensor-core bound and run twice for
    bitwise-equal results, and K1 forward under SDPA's forward; then the
    other K1 cases (non-causal, ragged L 1000, Lq 256 < Lk 1024, bf16
    (all three timed there too, beside SDPA in bf16), D 128 and D 36 in
    f32 and bf16) once each; then K3 at every shape of the training paths
    but BERT's (:func:`k3_train_rows`). Returns (timed rows, other cases,
    extra timings)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows, cases, extra = [], [], {}
    b, h, l, d = 8, 12, 1024, 64
    q, k, v, go = (randn(b, h, l, d) for _ in range(4))
    res = flash_case(torch, kfa, q, k, v, go, True)
    cost = attention_cost(b, h, l, l, d, True, 4)
    tol = FLASH_TOL["float32"]
    with torch.no_grad():
        out, lse = kfa.flash_forward(q, k, v, True)
        dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, True)
    shape = f"B{b} H{h} L{l} D{d} causal f32"
    for name, part, kernel, plain, lib in (
            ("flash_attention_fwd", "out",
             lambda i: kfa.flash_forward(q, k, v, True),
             lambda i: kfa.flash_forward_plain(q, k, v, True),
             lambda i: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)),
            ("flash_attention_bwd_dq", "dq",
             lambda i: kfa.flash_backward_dq(q, k, v, out, lse, go, True),
             lambda i: kfa.flash_backward_dq_plain(q, k, v, out, lse, go,
                                                   True), None),
            ("flash_attention_bwd_dkv", "dkv",
             lambda i: kfa.flash_backward_dkv(q, k, v, go, lse, delta, True),
             lambda i: kfa.flash_backward_dkv_plain(q, k, v, go, lse, delta,
                                                    True), None)):
        err, scale = res[part]
        if part == "out":
            err = max(err, res["lse"][0] / max(res["lse"][1], 1.0))
        nbytes, flops = cost["fwd" if part == "out" else part]
        with torch.no_grad():
            rows.append(measure(name, shape, err, tol * max(scale, 1.0),
                                kernel, plain, lib, nbytes, flops))
    # SDPA forward + backward beside the three kernels, one call each
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd(i):
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        torch.autograd.grad(o, (qs, ks, vs), go)

    extra["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, iters=20)[0]
    extra["k1_fwd_dq_dkv_ms"] = sum(r["ms"] for r in rows)
    # SDPA's backward alone, the yardstick of K1c + K1d: the
    # efficient-attention backward gives dQ, dK and dV in one call
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        extra["sdpa_bwd_ms"] = time_ms(
            lambda i: torch.autograd.grad(o, (qs, ks, vs), go,
                                          retain_graph=True), iters=20)[0]
    del o
    extra["k1c_k1d_ms"] = rows[1]["ms"] + rows[2]["ms"]
    for row, part in zip(rows[1:], ("dq", "dkv")):
        row["library_ms"] = extra["sdpa_bwd_ms"]   # one call for both
    # all three run on the tensor cores: that is their bound
    for row, part in zip(rows, ("fwd", "dq", "dkv")):
        use_tc_bound(row, *cost[part], "float32")
    check(rows[0]["ms"] < rows[0]["library_ms"],
          f"K1 forward {rows[0]['ms']} ms not under SDPA's forward "
          f"{rows[0]['library_ms']} ms")
    # no atomics: two runs of K1 forward, K1c and K1d give the same bits
    with torch.no_grad():
        runs = [kfa.flash_forward(q, k, v, True)
                + kfa.flash_backward_dq(q, k, v, out, lse, go, True)
                + kfa.flash_backward_dkv(q, k, v, go, lse, delta, True)
                for _ in range(2)]
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    print(f"K1 forward, K1c, K1d twice at {shape}: out, lse, dq, delta, dk, "
          f"dv bitwise equal {same}", flush=True)
    check(all(same), f"K1 forward / K1c / K1d not deterministic: {same}")
    extra["bitwise_repeatable"] = all(same)
    del runs
    print(f"attention fwd + bwd at {shape}: K1 forward + K1c + K1d "
          f"{extra['k1_fwd_dq_dkv_ms']:.5f} ms, SDPA forward + backward "
          f"{extra['sdpa_fwd_bwd_ms']:.5f} ms; K1c + K1d "
          f"{extra['k1c_k1d_ms']:.5f} ms, SDPA backward alone (efficient "
          f"attention, dQ, dK and dV in one call) "
          f"{extra['sdpa_bwd_ms']:.5f} ms", flush=True)
    del q, k, v, go, out, lse, dq, delta, qs, ks, vs

    # D 128 reaches the kernels' second tile width, D 36 the zero-padded
    # columns and, in bf16 (72-byte rows), the unaligned staging
    for case, (b, h, lq, lk, d, causal, dt) in {
            "non-causal": (2, 12, 1024, 1024, 64, False, torch.float32),
            "ragged L 1000": (2, 12, 1000, 1000, 64, True, torch.float32),
            "Lq 256 < Lk 1024": (2, 12, 256, 1024, 64, True, torch.float32),
            "bf16": (8, 12, 1024, 1024, 64, True, torch.bfloat16),
            "D 128": (2, 12, 1024, 1024, 128, True, torch.float32),
            "D 128 bf16": (2, 12, 1024, 1024, 128, True, torch.bfloat16),
            "D 36": (2, 12, 1000, 1000, 36, True, torch.float32),
            "D 36 bf16": (2, 12, 1000, 1000, 36, True,
                          torch.bfloat16)}.items():
        q, go = randn(b, h, lq, d, dtype=dt), randn(b, h, lq, d, dtype=dt)
        k, v = randn(b, h, lk, d, dtype=dt), randn(b, h, lk, d, dtype=dt)
        res = flash_case(torch, kfa, q, k, v, go, causal)
        tol = FLASH_TOL[str(dt)[6:]]
        for part, (err, scale) in res.items():
            limit = tol * max(scale, 1.0)
            print(f"flash {part} {case} B{b} H{h} Lq{lq} Lk{lk} D{d}: "
                  f"max_abs_err {err:.3e} (limit {limit:.3e})", flush=True)
            check(err <= limit, f"flash {part} {case}: {err} > {limit}")
            cases.append({"name": "flash_attention", "case": case,
                          "part": part, "max_abs_err": err, "limit": limit})
        if case == "bf16":
            extra["bf16"] = bf16_times(torch, kfa, q, k, v, go)
        del q, k, v, go

    # K3 at every shape of the training paths but BERT's
    k3_rows, k3_cases = k3_train_rows(torch, dev, g)
    rows += k3_rows
    cases += k3_cases
    return rows, cases, extra


# The one-pass route (the default policy, f32 operands rounded once to
# TF32), as a share of the reference's largest magnitude. Against the
# plain version that rounds the same operands: the forward rounds p
# relative to the running row max, the plain version relative to the
# final one, so each p may land one TF32 step (2^-11) apart; averaged
# over the keys that was 4.5e-5 in a CPU emulation at L 512, and 2e-4
# leaves 4x. Against the exact plain version: operands carry 10
# mantissa bits, each product is off by up to 2^-10 and sums of up to
# 1024 such terms add; 3e-4 to 6.7e-4 in that emulation, and 2e-3
# leaves 3x.
TF32_TOL, TF32_EXACT_TOL = 2e-4, 2e-3
# The same route at BERT's L 128, non-causal: a forward row averages 128
# keys and a dK/dV entry sums 128 queries, too few to average the
# kernel's and the plain version's one-step disagreements (each p or ds
# may round one TF32 step, 2^-11 = 4.9e-4 relative, apart) below
# TF32_TOL; one step of the largest magnitude bounds them, and 2^-10
# leaves 2x. Measured on one H100: 1.3e-4 (forward), 4.3e-5 (dQ) and
# 2.1e-4 (dK/dV) of the largest magnitude.
TF32_SHORT_TOL = 2.0 ** -10


def one_pass_checks(torch, dev):
    """Phase 2, the default policy's route: K1 forward, K1c and K1d in
    one TF32 pass at the train step's (8, 12, 1024, 64) causal f32,
    against the plain versions that round their operands to TF32
    (``TF32_TOL``) and against the exact ones (``TF32_EXACT_TOL``), run
    twice for bitwise-equal results, timed under the default policy
    against their one-pass bound, with SDPA's forward and backward under
    the same policy (TF32 allowed) as library yardsticks. Returns the
    three rows of the kernels line."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    b, h, l, d = 8, 12, 1024, 64
    q, k, v, go = (torch.randn(b, h, l, d, generator=g, device=dev)
                   for _ in range(4))
    near = flash_case(torch, kfa, q, k, v, go, True, "default", True)
    exact = flash_case(torch, kfa, q, k, v, go, True, "default", False)
    cost = attention_cost(b, h, l, l, d, True, 4)
    shape = f"B{b} H{h} L{l} D{d} causal f32, one TF32 pass"
    rows = []
    with torch.no_grad(), matmul_precision_scope("default"):
        check(kfa.kernel_route(torch.float32) == "tf32",
              "the default policy does not route f32 to one TF32 pass")
        out, lse = kfa.flash_forward(q, k, v, True)
        dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, True)
        for name, part, kernel, plain, lib in (
                ("flash_attention_fwd_tf32", "out",
                 lambda i: kfa.flash_forward(q, k, v, True),
                 lambda i: kfa.flash_forward_plain(q, k, v, True,
                                                   round_tf32=True),
                 lambda i: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True)),
                ("flash_attention_bwd_dq_tf32", "dq",
                 lambda i: kfa.flash_backward_dq(q, k, v, out, lse, go,
                                                 True),
                 lambda i: kfa.flash_backward_dq_plain(
                     q, k, v, out, lse, go, True, round_tf32=True), None),
                ("flash_attention_bwd_dkv_tf32", "dkv",
                 lambda i: kfa.flash_backward_dkv(q, k, v, go, lse, delta,
                                                  True),
                 lambda i: kfa.flash_backward_dkv_plain(
                     q, k, v, go, lse, delta, True, round_tf32=True),
                 None)):
            errs = {}
            for which, res in (("near", near), ("exact", exact)):
                err, scale = res[part]
                if part == "out":
                    err = max(err, res["lse"][0] / max(res["lse"][1], 1.0))
                errs[which] = (err, scale)
            xerr, xscale = errs["exact"]
            xlim = TF32_EXACT_TOL * max(xscale, 1.0)
            print(f"{name} {shape}: max_abs_err against the exact plain "
                  f"version {xerr:.3e} (limit {xlim:.3e})", flush=True)
            check(xerr <= xlim, f"{name}: against the exact plain version "
                  f"{xerr} > {xlim}")
            nbytes, flops = cost["fwd" if part == "out" else part]
            err, scale = errs["near"]
            row = measure(name, shape, err, TF32_TOL * max(scale, 1.0),
                          kernel, plain, lib, nbytes, flops)
            row.update(exact_err=xerr, exact_limit=xlim)
            use_tc_bound(row, nbytes, flops, "float32", passes=1)
            rows.append(row)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            sdpa_bwd = time_ms(lambda i: torch.autograd.grad(
                o, (qs, ks, vs), go, retain_graph=True), iters=20)[0]
        for row in rows[1:]:
            row["library_ms"] = sdpa_bwd     # one call for dQ, dK and dV
        runs = [kfa.flash_forward(q, k, v, True)
                + kfa.flash_backward_dq(q, k, v, out, lse, go, True)
                + kfa.flash_backward_dkv(q, k, v, go, lse, delta, True)
                for _ in range(2)]
    same = [torch.equal(a, b_) for a, b_ in zip(*runs)]
    print(f"one TF32 pass at B{b} H{h} L{l} D{d}: out, lse, dq, delta, dk, "
          f"dv bitwise equal on two runs {same}; SDPA backward with TF32 "
          f"allowed {sdpa_bwd:.5f} ms against K1c + K1d "
          f"{rows[1]['ms'] + rows[2]['ms']:.5f}", flush=True)
    check(all(same), f"one-pass K1 not deterministic: {same}")
    return rows


def bert_kernel_checks(torch, dev):
    """Phase 2 at phase 12's shapes. K1 forward, K1c and K1d non-causal at
    BERT-base's (32, 12, 128, 64) f32 under highest (three TF32 passes,
    FLASH_TOL) and under default (one pass: TF32_SHORT_TOL against the
    plain versions that round to TF32, TF32_EXACT_TOL against the exact
    ones),
    each run twice for the same bits and timed against its tensor-core
    bound and SDPA under the same policy; L 128 is two 64-row query tiles
    a head, every key tile full. K3 (:func:`k3_bert_rows`) at the MLM
    loss's (4096, 30522) and the NSP loss's (32, 2) f32 logits, rows of
    no 16-byte multiple. Returns the rows."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    b, h, l, d = BERT_B, 12, BERT_L, 64
    q, k, v, go = (torch.randn(b, h, l, d, generator=g, device=dev)
                   for _ in range(4))
    cost = attention_cost(b, h, l, l, d, False, 4)
    rows = []
    for policy, passes in (("highest", 3), ("default", 1)):
        one = passes == 1
        near = flash_case(torch, kfa, q, k, v, go, False, policy, one)
        exact = flash_case(torch, kfa, q, k, v, go, False, policy) \
            if one else near
        shape = f"B{b} H{h} L{l} D{d} non-causal f32" + (
            ", one TF32 pass" if one else "")
        tol = TF32_SHORT_TOL if one else FLASH_TOL["float32"]
        suffix = "_tf32" if one else ""
        part_rows = []
        with torch.no_grad(), matmul_precision_scope(policy):
            out, lse = kfa.flash_forward(q, k, v, False)
            dq, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, False)
            for name, part, kernel, plain, lib in (
                    ("flash_attention_fwd", "out",
                     lambda i: kfa.flash_forward(q, k, v, False),
                     lambda i: kfa.flash_forward_plain(
                         q, k, v, False, round_tf32=one),
                     lambda i: F.scaled_dot_product_attention(q, k, v)),
                    ("flash_attention_bwd_dq", "dq",
                     lambda i: kfa.flash_backward_dq(q, k, v, out, lse, go,
                                                     False),
                     lambda i: kfa.flash_backward_dq_plain(
                         q, k, v, out, lse, go, False, round_tf32=one),
                     None),
                    ("flash_attention_bwd_dkv", "dkv",
                     lambda i: kfa.flash_backward_dkv(q, k, v, go, lse,
                                                      delta, False),
                     lambda i: kfa.flash_backward_dkv_plain(
                         q, k, v, go, lse, delta, False, round_tf32=one),
                     None)):
                errs = {}
                for which, res in (("near", near), ("exact", exact)):
                    err, scale = res[part]
                    if part == "out":
                        err = max(err, res["lse"][0]
                                  / max(res["lse"][1], 1.0))
                    errs[which] = (err, scale)
                if one:
                    xerr, xscale = errs["exact"]
                    xlim = TF32_EXACT_TOL * max(xscale, 1.0)
                    print(f"{name}{suffix} {shape}: max_abs_err against the "
                          f"exact plain version {xerr:.3e} (limit "
                          f"{xlim:.3e})", flush=True)
                    check(xerr <= xlim, f"{name}{suffix} {shape}: {xerr}")
                err, scale = errs["near"]
                nbytes, flops = cost["fwd" if part == "out" else part]
                row = measure(name + suffix, shape, err,
                              tol * max(scale, 1.0), kernel, plain, lib,
                              nbytes, flops)
                use_tc_bound(row, nbytes, flops, "float32", passes)
                part_rows.append(row)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(qs, ks, vs)
                sdpa_bwd = time_ms(lambda i: torch.autograd.grad(
                    o, (qs, ks, vs), go, retain_graph=True), iters=20)[0]
            for row in part_rows[1:]:
                row["library_ms"] = sdpa_bwd   # one call for dQ, dK and dV
            runs = [kfa.flash_forward(q, k, v, False)
                    + kfa.flash_backward_dq(q, k, v, out, lse, go, False)
                    + kfa.flash_backward_dkv(q, k, v, go, lse, delta, False)
                    for _ in range(2)]
        same = [torch.equal(a, b_) for a, b_ in zip(*runs)]
        print(f"K1 forward, K1c, K1d at {shape}: out, lse, dq, delta, dk, dv "
              f"bitwise equal on two runs {same}; SDPA backward "
              f"({policy}) {sdpa_bwd:.5f} ms against K1c + K1d "
              f"{part_rows[1]['ms'] + part_rows[2]['ms']:.5f}", flush=True)
        check(all(same), f"K1 at {shape} not deterministic: {same}")
        rows += part_rows
        del runs, o, qs, ks, vs
    del q, k, v, go
    return rows + k3_bert_rows(torch, dev, g)


def k3_bert_rows(torch, dev, g):
    """K3 at BERT's heads, rows of no 16-byte multiple: the MLM head's
    (4096, 30522) on the wide route's peeled head (every other row starts
    8 bytes past a boundary), no slower than the first design, and the
    NSP head's (32, 2) on the warp route (too few bytes for the rows
    route's set-up), each also at a 4-byte offset. Returns the rows."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    rows = []
    for n, vocab, route in ((BERT_B * BERT_L, BERT_VOCAB, "wide"),
                            (BERT_B, 2, "warp")):
        xs = k3_sets(torch, randn, n, vocab, torch.float32)
        labels = torch.randint(0, vocab, (n,), generator=g, device=dev)
        case = f"({n}, {vocab}) f32, unaligned rows"
        rows.append(k3_case(torch, xs, case, route, labels))
        if route == "wide":
            k3_keeps_pace(rows[-1])
        rows[-1]["offset"] = k3_offset(torch, xs[0], case)
        del xs
    return rows


# --k3: the widths swept (k3_sweep), up to a little past the rows route's
K3_SWEEP_V = (2, 8, 16, 21, 32, 48, 64, 100, 128, 256, 512)
K3_SWEEP_BYTES = 128 << 20      # logits a width: read from device memory
# few rows: the launch's fixed cost against its bytes, by route
K3_SWEEP_FEW = ((2, "float32"), (21, "float32"), (21, "bfloat16"))
K3_SWEEP_N = (32, 256, 1024, 4096, 16384, 65536)


def k3_sweep(torch, dev):
    """The measurements behind ``lse_route``'s cuts: every K3 route (the
    rows route up to 256-byte rows) at each width of K3_SWEEP_V in f32
    and bf16, about K3_SWEEP_BYTES of logits each, checked against
    lse_plain and timed in one loop; then every route at K3_SWEEP_FEW's
    widths over K3_SWEEP_N rows, input sets cycled past the L2. Prints a
    table; returns the times."""
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    lib = _build.load("cross_entropy")
    stream = _build.stream_ptr(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 17)
    out = {"widths": [], "few": []}

    def launch(x, lse, route):
        _build.check(kce.lse_launch(lib, route, x, lse, stream),
                     f"cross_entropy_lse {route} route")

    def sweep(xs, rec, iters):
        """Each route on the sets xs into rec, checked on set 0."""
        x = xs[0]
        n, v = x.shape
        size = x.element_size()
        want = kce.lse_plain(x)
        lse = torch.empty((n,), dtype=torch.float32, device=dev)
        rec.update(chosen=kce.lse_route(x),
                   bound_ms=bound_ms(n * v * size + 4 * n, 4 * n * v)[0])
        for route in ("rows", "warp", "wide", "block"):
            if route == "rows" and v * size > kce.LSE_ROWS_MAX_BYTES:
                continue
            launch(x, lse, route)
            err = (lse - want).abs().max().item()
            check(err <= K3_TOL, f"k3_sweep ({n}, {v}) {rec['dtype']} "
                  f"{route}: max err {err}")
            rec[route] = time_ms(lambda i: launch(xs[i], lse, route),
                                 xs.shape[0], iters)[0]
        return (f"bound {rec['bound_ms']:.6f} ms; " + ", ".join(
            f"{r} {rec[r]:.5f}" for r in ("rows", "warp", "wide", "block")
            if r in rec) + f"; lse_route {rec['chosen']}")

    for dtype in (torch.float32, torch.bfloat16):
        size = torch.empty((), dtype=dtype).element_size()
        for v in K3_SWEEP_V:
            n = max(1, K3_SWEEP_BYTES // (v * size))
            xs = (torch.randn(1, n, v, generator=g, device=dev) * 2.0
                  ).to(dtype)
            rec = {"v": v, "n": n, "dtype": str(dtype)[6:]}
            line = sweep(xs, rec, 100)
            out["widths"].append(rec)
            print(f"k3_sweep ({n}, {v}) {rec['dtype']}: {line}", flush=True)
            del xs
    for v, dt in K3_SWEEP_FEW:
        dtype = getattr(torch, dt)
        for n in K3_SWEEP_N:
            xs = k3_sets(torch, lambda *s_: torch.randn(*s_, generator=g,
                                                        device=dev),
                         n, v, dtype)
            sets = xs.shape[0]
            rec = {"v": v, "n": n, "dtype": dt, "sets": sets}
            line = sweep(xs, rec, max(100, sets))
            out["few"].append(rec)
            print(f"k3_sweep ({n}, {v}) {dt}, {sets} input sets"
                  f"{k3_residence(xs.numel() * xs.element_size())}: {line}",
                  flush=True)
            del xs
    return out


def k3_phase(torch, dev):
    """--k3: phase 1, then the sweep and every K3 row of phase 2 (on
    random logits, SSD300's shape included)."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    res = {"sweep": k3_sweep(torch, dev)}
    res["rows"], res["cases"] = k3_train_rows(torch, dev, g)
    res["rows"] += k3_bert_rows(torch, dev, g)
    return res


def bf16_times(torch, kfa, q, k, v, go):
    """K1 forward, K1c and K1d on the bf16 case at the train step's
    shape, timed against their tensor-core bounds and SDPA's bf16
    forward and backward (PyTorch picks the backend)."""
    import torch.nn.functional as F

    b, h, l, d = q.shape
    cost = attention_cost(b, h, l, l, d, True, 2)
    with torch.no_grad():
        fwd_ms = time_ms(lambda i: kfa.flash_forward(q, k, v, True))[0]
        sdpa_fwd_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))[0]
        out, lse = kfa.flash_forward(q, k, v, True)
        _, delta = kfa.flash_backward_dq(q, k, v, out, lse, go, True)
        dq_ms = time_ms(lambda i: kfa.flash_backward_dq(
            q, k, v, out, lse, go, True))[0]
        dkv_ms = time_ms(lambda i: kfa.flash_backward_dkv(
            q, k, v, go, lse, delta, True))[0]
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa_ms = time_ms(lambda i: torch.autograd.grad(
        o, (qs, ks, vs), go, retain_graph=True), iters=20)[0]
    res = {"fwd_ms": fwd_ms, "sdpa_fwd_ms": sdpa_fwd_ms, "dq_ms": dq_ms,
           "dkv_ms": dkv_ms, "sdpa_bwd_ms": sdpa_ms,
           "fwd_tc_bound_ms": tc_bound_ms(*cost["fwd"], "bfloat16")[0],
           "dq_tc_bound_ms": tc_bound_ms(*cost["dq"], "bfloat16")[0],
           "dkv_tc_bound_ms": tc_bound_ms(*cost["dkv"], "bfloat16")[0]}
    print(f"bf16 at B{b} H{h} L{l} D{d} causal: K1 forward {fwd_ms:.5f} ms "
          f"(tensor-core bound {res['fwd_tc_bound_ms']:.6f}), SDPA bf16 "
          f"forward {sdpa_fwd_ms:.5f} ms; K1c "
          f"{dq_ms:.5f} ms (bound {res['dq_tc_bound_ms']:.6f}), "
          f"K1d {dkv_ms:.5f} ms (bound {res['dkv_tc_bound_ms']:.6f}), "
          f"together {dq_ms + dkv_ms:.5f}; SDPA bf16 backward {sdpa_ms:.5f} "
          f"ms", flush=True)
    return res


def rms_tol(dtype, ref):
    """K2r's tolerance against its plain version, from the largest
    magnitude of the reference: f32 sums of up to 8192 terms in another
    order, 2e-6 of it; bf16 values rounded once from f32 on both sides,
    one bf16 ulp (2^-7) of it."""
    rel = 2e-6 if dtype == "float32" else 2.0 ** -7
    return rel * max(ref.float().abs().max().item(), 1.0)


def frontdoor_kernel_checks(torch, dev):
    """Phase 2, the front-door slice's kernels. K2r forward at the
    stack's (8192, 768) and (8, 768) in f32 (timed, against
    torch.nn.functional.rms_norm) and bf16, a ragged D 1000 with 37 rows
    (no block multiple), and its backward through the autograd Function
    against the plain port of _rms_bwd; then kernel R: NVRTC compiles
    USER_SOURCE, axpy on 2^24 floats and row_absmax_scale on the stack's
    (8192, 768) input must equal their torch expressions exactly (f32),
    each timed against its bound and one torch call. Returns (timed rows,
    other cases, the compiled module, extra numbers)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    rows, cases, extra = [], [], {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(dtype)

    for n, d in ((8192, 768), (8, 768), (37, 1000)):
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            x = (randn(n, d, scale=2.0) + 0.5).to(dt)
            gam = (randn(d, scale=0.1) + 1.0).to(dt)
            y, rstd = kln.fused_rms_norm(x, gam, 1e-6)
            py, prstd = kln.rms_norm_plain(x, gam, 1e-6)
            check(y.dtype == py.dtype == dt, f"rms_norm_fwd {name}: dtype")
            errs = {"y": ((y.float() - py.float()).abs().max().item(),
                          rms_tol(name, py)),
                    "rstd": ((rstd - prstd).abs().max().item(),
                             rms_tol("float32", prstd))}
            if (n, d) != (8, 768):
                xg = x.detach().requires_grad_()
                gg = gam.detach().requires_grad_()
                gy = randn(n, d, dtype=dt)
                dx, dgam = torch.autograd.grad(
                    kln.fused_rms_norm(xg, gg, 1e-6)[0], (xg, gg), gy)
                pdx, pdgam = kln.rms_norm_backward(x, gam, prstd, gy)
                for part, a, b in (("dx", dx, pdx), ("dgamma", dgam, pdgam)):
                    errs[part] = ((a.float() - b.float()).abs().max().item(),
                                  rms_tol(name, b))
            case = f"({n}, {d}) {name}"
            for part, (err, tol) in errs.items():
                check(torch.isfinite(torch.tensor(err)).item()
                      and err <= tol,
                      f"rms_norm_fwd {case} {part}: {err} > {tol}")
            print(f"rms_norm_fwd {case}: " + ", ".join(
                f"{k} max_abs_err {e:.3e} (tol {t:.3e})"
                for k, (e, t) in errs.items()), flush=True)
            cases.append({"name": "rms_norm_fwd", "case": case,
                          "errors": errs})
            if dt == torch.float32 and d == 768:
                err = max(errs["y"][0], errs["rstd"][0])
                tol = max(errs["y"][1], errs["rstd"][1])
                rows.append(measure(
                    "rms_norm_fwd", case, err, tol,
                    lambda i: kln.fused_rms_norm(x, gam, 1e-6),
                    lambda i: kln.rms_norm_plain(x, gam, 1e-6),
                    lambda i: F.rms_norm(x, (d,), gam, 1e-6),
                    4 * (2 * n * d + d + n), 4 * n * d))

    # kernel R ---------------------------------------------------------------
    major, minor = rtc.nvrtc_version()
    t0 = time.perf_counter()
    mod = rtc.CudaModule(USER_SOURCE, exports=["axpy", "row_absmax_scale"])
    extra["nvrtc_version"] = f"{major}.{minor}"
    extra["compile_s"] = time.perf_counter() - t0
    print(f"NVRTC {major}.{minor}: compiled the user module (axpy, "
          f"row_absmax_scale) for sm_90a in {extra['compile_s']:.3f} s",
          flush=True)
    axpy = mod.get_kernel("axpy", "int n, const float *x, const float *y, "
                          "float *o")
    n = 1 << 24
    x, y = randn(n), randn(n)
    grid = ((n + 255) // 256,)

    def run_axpy(i):
        return axpy.launch([n, x, y], out_shapes=[(n,)], grid=grid,
                           block=(256,))

    exact = torch.equal(run_axpy(0), 2 * x + y)
    check(exact, "rtc axpy differs from 2 * x + y")
    ms, _ = time_ms(run_axpy)
    plain_ms, _ = time_ms(lambda i: 2 * x + y)
    lib_ms, _ = time_ms(lambda i: torch.add(y, x, alpha=2))
    bms, by = bound_ms(12 * n, 2 * n)
    extra["axpy"] = {"n": n, "exact": exact, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
    print(f"rtc axpy on 2^24 floats: equal to 2 * x + y; ms {ms:.5f} "
          f"plain_ms {plain_ms:.5f} library_ms {lib_ms:.5f} (torch.add "
          f"alpha=2) bound_ms {bms:.6f} ({by}, 12 bytes per element)",
          flush=True)
    scale = mod.get_kernel("row_absmax_scale", "const float *x, int d, "
                           "float *o")
    rn, d = FD_B * FD_L, FD_UNITS
    xs = randn(rn, d)
    want = xs / xs.abs().amax(-1, keepdim=True)
    got = row_scale(scale, xs)
    check(torch.equal(got, want), "rtc row_absmax_scale differs from x / "
          "max|x| per row")
    # 64 KB of dynamic shared memory (above the 48 KB default): 1024 rows
    big = scale.launch([xs[:1024], d], out_shapes=[(1024, d)], grid=(1024,),
                       block=(1024,), shared_mem=64 * 1024)
    check(torch.equal(big, want[:1024]), "rtc row_absmax_scale with 64 KB "
          "of dynamic shared memory differs")
    rows.append(measure(
        "rtc_row_absmax_scale", f"({rn}, {d}) f32, grid {rn}, block "
        f"{ROW_SCALE_THREADS}, {4 * ROW_SCALE_THREADS} B dynamic shared",
        0.0, 0.0, lambda i: row_scale(scale, xs),
        lambda i: xs / xs.abs().amax(-1, keepdim=True),
        lambda i: F.normalize(xs, p=float("inf"), dim=-1),
        8 * rn * d, 2 * rn * d))
    del x, y, xs, want, got, big
    return rows, cases, mod, extra


def row_scale(kernel, x):
    """The user kernel row_absmax_scale on (N, D) rows: x / max|x| per
    row, one block per row."""
    n, d = x.shape
    return kernel.launch([x, d], out_shapes=[(n, d)], grid=(n,),
                         block=(ROW_SCALE_THREADS,),
                         shared_mem=4 * ROW_SCALE_THREADS)


# the front-door path: gpt_like's widths (model_zoo/bert.py:224)
FD_UNITS, FD_HIDDEN, FD_LAYERS = 768, 3072, 12
FD_B, FD_L, FD_STEPS = 8, 1024, 5
FD_PARAMS = FD_LAYERS * (2 * FD_UNITS * FD_HIDDEN + FD_HIDDEN + 2 * FD_UNITS) \
    + FD_UNITS


def ffn_stack(gluon, layers=FD_LAYERS, units=FD_UNITS, hidden=FD_HIDDEN):
    """layers x [x + Dense(units)(Dense(hidden, gelu)(RMSNorm()(x)))] and
    a final RMSNorm, each layer without in_units/in_channels, from the
    port's Gluon (tests/test_torch_frontdoor.py builds the same stack in
    both packages)."""
    nn = gluon.nn

    class FFNBlock(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.norm = nn.RMSNorm()
            self.ffn_1 = nn.Dense(hidden, activation="gelu", flatten=False)
            self.ffn_2 = nn.Dense(units, flatten=False)

        def forward(self, x):
            return x + self.ffn_2(self.ffn_1(self.norm(x)))

    net = nn.HybridSequential()
    for _ in range(layers):
        net.add(FFNBlock())
    net.add(nn.RMSNorm())
    return net


def frontdoor_steps(torch, dev, card, wrappers, step, profile, policy):
    """Phase 8's timed steps under the matmul ``policy`` (set by the
    caller): a warm-up step, then 5 timed steps with exact launch counts
    and a loss that falls below the warm-up's."""
    first = step().mean().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    losses, host_ms, span_ms = [], [], []
    for _ in range(FD_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
        losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers},
                rms_norm_fwd=FD_STEPS * (FD_LAYERS + 1),
                rtc_row_absmax_scale=FD_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and np.isfinite(first),
          f"non-finite loss {first} {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses}")
    check(counts == want, f"front-door launches {counts} != {want}")
    step_ms = float(np.mean(host_ms))
    out = {"warmup_loss": first, "losses": losses, "host_ms": host_ms,
           "device_span_ms": span_ms, "step_ms": step_ms,
           "tok_s": FD_B * FD_L / step_ms * 1e3, "max_memory_allocated": peak,
           "launches": counts, "policy": policy}
    print(f"front door on {card}, matmul precision {policy}: RMSNorm FFN "
          f"stack ({FD_LAYERS} blocks, {FD_UNITS}/{FD_HIDDEN}) B{FD_B} "
          f"L{FD_L} Adam lr 1e-3, L2Loss; loss {first:.6f} (warm-up) -> "
          f"{[round(v, 6) for v in losses]}; step ms (host wall to a "
          f"synchronise) {[round(v, 3) for v in host_ms]}, device span ms "
          f"(CUDA events) {[round(v, 3) for v in span_ms]}; "
          f"{out['tok_s']:.1f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches over {FD_STEPS} steps {counts}",
          flush=True)
    if profile:
        dev_ms, wall_ms, _ = profile_train_step(
            torch, step, f"frontdoor_profile_{policy}.txt")
        out["profile"] = {"device_ms": dev_ms, "wall_ms": wall_ms}
        print(f"front-door step ({policy}), profiler: device ms summed over "
              f"kernels {'not measured' if dev_ms is None else f'{dev_ms:.3f}'}"
              f", wall ms {wall_ms:.3f}"
              + ("" if dev_ms is None else
                 f", device busy {dev_ms / wall_ms:.3f}"), flush=True)
    return out


def frontdoor_phase(torch, card, wrappers, scale_kernel, profile):
    """Phase 8: the front-door path. The RMSNorm FFN stack is built with
    deferred shapes, initialized with Xavier on gpu(0), and trained with
    Adam (lr 1e-3) on L2Loss against a target: inputs and targets
    (8, 1024, 768) from mx.np.random.normal at seed 0, each step's input
    scaled per row by the user kernel row_absmax_scale (kernel R). One
    warm-up step completes the shapes; 5 timed steps follow, with exact
    launch counts and a falling loss. Then a B 2 step through the kernels
    against no_kernels, and a .params round trip into a fresh stack."""
    import shutil

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops import nn as tnn

    dev = mx.context.resolve_device(None)
    net = ffn_stack(mx.gluon)
    net.initialize(mx.init.Xavier())                  # gpu(0) by default
    params = net.collect_params()
    deferred = [n for n, p in params.items() if not p.initialized]
    check(len(deferred) == 3 * FD_LAYERS + 1 and all(
        0 in params[n].shape for n in deferred),
        f"deferred before the first forward: {deferred}")
    mx.np.random.seed(SEED)
    x = mx.np.random.normal(size=(FD_B, FD_L, FD_UNITS))
    target = mx.np.random.normal(size=(FD_B, FD_L, FD_UNITS))
    loss_fn = mx.gluon.loss.L2Loss()
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    rows = FD_B * FD_L

    def step():
        inp = row_scale(scale_kernel, x.reshape(rows, FD_UNITS))
        with autograd.record():
            loss = loss_fn(net(inp.reshape(x.shape)), target)
        autograd.backward(loss)
        trainer.step(FD_B)
        return loss.detach()

    t0 = time.perf_counter()
    first = step().mean().item()                      # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n_params = sum(p.data().numel() for p in params.values())
    check(all(p.initialized for p in params.values()), "deferred after the "
          "first forward")
    check(n_params == FD_PARAMS, f"{n_params} parameters != {FD_PARAMS}")
    check(params["0.ffn_1.weight"].shape == (FD_HIDDEN, FD_UNITS)
          and params[f"{FD_LAYERS - 1}.ffn_2.weight"].shape
          == (FD_UNITS, FD_HIDDEN)
          and params[f"{FD_LAYERS}.gamma"].shape == (FD_UNITS,),
          "completed shapes")
    print(f"front door: the RMSNorm FFN stack had {len(deferred)} deferred "
          f"parameters before its first forward; after it, {n_params} "
          f"parameters on {params['0.ffn_1.weight'].data().device} "
          f"(warm-up step {warm_s:.2f} s)", flush=True)
    out = {"batch": FD_B, "seq": FD_L, "params": n_params,
           "warmup_loss": first, "card": card}
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            out[policy] = frontdoor_steps(torch, dev, card, wrappers, step,
                                          profile, policy)

    # B 2 through the kernels against no_kernels -----------------------------
    inp = row_scale(scale_kernel, x[:2].reshape(2 * FD_L, FD_UNITS)).reshape(
        2, FD_L, FD_UNITS)

    def grads():
        for w in wrappers.values():
            w.launches = 0
        with autograd.record():
            loss = loss_fn(net(inp), target[:2])
        autograd.backward(loss)
        got = {n: p.grad().clone() for n, p in params.items()}
        net.zero_grad(set_to_none=True)
        return loss.detach(), got, {k: w.launches for k, w in wrappers.items()}

    loss_k, grad_k, counts_k = grads()
    with tnn.no_kernels():
        loss_p, grad_p, counts_p = grads()
    check(counts_k == dict({k: 0 for k in wrappers},
                           rms_norm_fwd=FD_LAYERS + 1),
          f"one forward launched {counts_k}")
    check(not any(counts_p.values()), f"no_kernels launched {counts_p}")
    loss_err = (loss_k - loss_p).abs().max().item()
    check(loss_err <= 1e-5 * loss_p.abs().max().item(),
          f"front-door loss kernels vs plain: {loss_err}")
    worst, worst_name = 0.0, None
    for name, gp in grad_p.items():
        gk = grad_k[name]
        check(torch.isfinite(gk).all().item(), f"{name}: non-finite grad")
        ratio = ((gk - gp).abs().max() / gp.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
        if name.endswith("gamma"):
            check(gk.abs().max().item() > 0, f"{name}: zero gradient")
    check(worst <= 1e-3, f"gradient {worst_name}: {worst} > 1e-3")
    with matmul_precision_scope("default"):
        loss_d, grad_d, _ = grads()
    out["default_vs_highest"] = policy_diff(torch, "front door B2", loss_d,
                                            grad_d, loss_k, grad_k)
    n_gamma = sum(n.endswith("gamma") for n in grad_p)
    print(f"front door B2 L{FD_L}, kernels vs no_kernels on the card: loss "
          f"{loss_k.tolist()} vs {loss_p.tolist()} (max err "
          f"{loss_err:.3e}); {len(grad_p)} gradients, worst max|err| / "
          f"max|g| {worst:.3e} ({worst_name}, limit 1e-3); all {n_gamma} "
          f"RMSNorm gains have non-zero gradients; launches {counts_k}",
          flush=True)
    out["grad_check"] = {"loss_err": loss_err, "worst_grad_ratio": worst,
                         "worst_grad": worst_name, "launches": counts_k}

    # .params round trip into a fresh stack ----------------------------------
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mxnet_tpu_torch", "_build", "chip_smoke_params")
    os.makedirs(tmp, exist_ok=True)
    try:
        fname = os.path.join(tmp, "ffn_stack.params")
        net.save_parameters(fname)
        size = os.path.getsize(fname)
        fresh = ffn_stack(mx.gluon)
        fresh.load_parameters(fname)                  # gpu(0) by default
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fp = fresh.collect_params()
    check(list(fp) == list(params), "fresh stack names differ")
    for name, p in params.items():
        check(torch.equal(fp[name].data(), p.data()),
              f"{name}: .params round trip not bitwise")
    with torch.no_grad():
        same = torch.equal(fresh(inp), net(inp))
    check(same, "fresh stack's output differs after load_parameters")
    print(f"front door .params round trip: {size} bytes, all {len(fp)} "
          f"parameters bitwise equal in a fresh stack, same output",
          flush=True)
    out["params_bytes"] = size
    return out


def seeded_params(model, seed):
    """Numpy weights under the reference's parameter names: normal with
    std 0.02 (LayerNorm gains 1 + that)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, t in model.state_dict().items():
        v = rng.standard_normal(tuple(t.shape), dtype=np.float32) * 0.02
        if name.endswith(".gamma"):
            v += 1.0
        params[name] = v
    return params


def decode_state(torch, model, lengths, gen):
    """A decode step's inputs at per-lane ``lengths``: int8 pools of
    random K/V, each lane's blocks in its own table row, every lane's new
    token at position ``length - 1``."""
    from mxnet_tpu_torch.ops import nn as tnn

    dev = model.word_embed.weight.data().device
    bs, r = 16, len(lengths)
    mb = CFG["max_length"] // bs
    need = [-(-int(n) // bs) for n in lengths]
    pk, pv = model.init_block_pool(sum(need) + 1, bs, dtype="int8")
    for pool in (pk, pv):
        for layer in pool:              # one layer at a time: less memory
            layer.copy_(tnn.kv_cache_quantize(torch.randn(
                layer.shape[:-1] + (layer.shape[-1] - 4,), generator=gen,
                device=dev)))
    table = torch.full((r, mb), sum(need), dtype=torch.int32, device=dev)
    first = 0
    for i, k in enumerate(need):
        table[i, :k] = torch.arange(first, first + k, dtype=torch.int32)
        first += k
    pos = torch.tensor([int(n) - 1 for n in lengths], dtype=torch.int32,
                       device=dev)
    toks = torch.randint(0, CFG["vocab_size"], (r, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    return toks, pk, pv, table, pos


def replay_equals_eager(torch, model, run, args, gen, prompt, wrappers):
    """Phase 4: one replay of the decode graph gives bitwise the next
    tokens and pools of one eager call of the same program on the same
    inputs, with the same launches; the same for the prefill of
    ``prompt`` in its bucket. Each graph is captured first (its capture
    runs the step once), the pools are reset in place, and then it
    replays once."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        paged_prefill_program)

    toks, pk, pv, table, pos = args
    bs = 16
    p = len(prompt)
    bucket = bs * max(1, 1 << (-(-p // bs) - 1).bit_length())
    nb = bucket // bs
    prog = paged_prefill_program(model, prefill_len=bucket, block_size=bs,
                                 kv_cache_dtype="int8")
    ids = torch.arange(nb, dtype=torch.int64)
    padded = torch.zeros((1, bucket), dtype=torch.int32)
    padded[0, :p] = torch.from_numpy(prompt)
    fresh = model.init_block_pool(nb + 1, bs, dtype="int8")
    return replays_equal_eager(torch, wrappers, (
        ("decode", run, (pk, pv), None,
         lambda call, k_, v_: call(toks, k_, v_, table, pos, gen)),
        (f"prefill bucket {bucket}", prog, fresh, None,
         lambda call, k_, v_: call(padded, p - 1, k_, v_, ids, gen))))


def replays_equal_eager(torch, wrappers, cases):
    """For each ``(name, program, pools, expected, call)``: capture the
    program's graph (its first call), reset the pools in place, replay
    it once, then run one eager call on copies of the same pools. The
    outputs (all but the two pools), the pools and the launches must be
    bitwise equal, and the launches ``expected`` where it is given."""
    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    out = {}
    for name, program, pools, expected, call in cases:
        gk, gv = (t.clone() for t in pools)
        call(program, gk, gv)                     # captures
        gk.copy_(pools[0])
        gv.copy_(pools[1])
        zero()
        got = [t.clone() for t in call(program, gk, gv)[:-2]]
        replay_counts = counts()
        ek, ev = (t.clone() for t in pools)
        zero()
        want = call(program.eager, ek, ev)[:-2]
        eager_counts = counts()
        same = {"outputs": all(torch.equal(a_, b_)
                               for a_, b_ in zip(got, want)),
                "pool_k": torch.equal(gk, ek), "pool_v": torch.equal(gv, ev),
                "launches": replay_counts == eager_counts
                and expected in (None, replay_counts)}
        print(f"{name}: one replay against one eager call, bitwise equal "
              f"{same}; launches {replay_counts}"
              + (f", expected {expected}" if expected else ""), flush=True)
        check(all(same.values()), f"{name}: replay differs from eager {same}")
        out[name] = dict(same, launches=replay_counts)
        del gk, gv, ek, ev
    return out


def sampling_check(torch, model, prompt):
    """A sampling engine (top-k 50, temperature 0.8) replays graphs that
    draw from its generator: two requests for the same prompt give tokens
    in the vocabulary that differ, and the generator's offset advanced."""
    from mxnet_tpu_torch.serving.llm import LLMEngine

    with LLMEngine(model, greedy=False, temperature=0.8, top_k=50,
                   seed=3) as eng:
        eng.warmup([len(prompt)])
        state = eng._gen.get_state().clone()
        outs = [eng.generate(prompt, 8) for _ in range(2)]
        moved = not torch.equal(state, eng._gen.get_state())
        graphs = eng.stats()["graphs"]
    ok = all(((o >= 0) & (o < CFG["vocab_size"])).all() for o in outs)
    print(f"sampling engine (top-k 50, temperature 0.8) replaying graphs: "
          f"{outs[0].tolist()} then {outs[1].tolist()}; generator moved "
          f"{moved}; graphs {graphs}", flush=True)
    check(ok and moved and not np.array_equal(outs[0], outs[1]),
          "sampling through the graphs does not draw anew")
    return {"tokens": [o.tolist() for o in outs], "generator_moved": moved,
            "graphs": graphs}


def prefill_times(torch, model, card, prompts, buckets):
    """Phase 5: each bucket of the served run's prefills, replayed and
    eager, device against host ms (int8 pools, a prompt of the served
    run that falls in the bucket)."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        paged_prefill_program)

    dev = model.word_embed.weight.data().device
    gen = torch.Generator(device=dev)
    bs, out = 16, {}
    for bucket in buckets:
        prompt = next((q for q in prompts
                       if bucket // 2 < len(q) <= bucket), None)
        if prompt is None:
            continue
        p, nb = len(prompt), bucket // bs
        prog = paged_prefill_program(model, prefill_len=bucket,
                                     block_size=bs, kv_cache_dtype="int8")
        pk, pv = model.init_block_pool(nb + 1, bs, dtype="int8")
        # inputs on the card: a copy from pageable host memory would wait
        # for time_ms's spin kernel
        ids = torch.arange(nb, dtype=torch.int64, device=dev)
        last = torch.tensor([p - 1], dtype=torch.int64, device=dev)
        padded = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        padded[0, :p] = torch.from_numpy(prompt).to(dev)
        row = {"prompt": p}
        for mode, call in (("replayed", prog), ("eager", prog.eager)):
            dev_ms, host_ms = time_ms(
                lambda i: call(padded, last, pk, pv, ids, gen), iters=10,
                warmup=2)
            row[mode] = {"device_ms": dev_ms, "host_ms": host_ms,
                         "device_busy": dev_ms / host_ms}
        out[bucket] = row
        print(f"prefill bucket {bucket} (prompt {p}) on {card}: replayed "
              f"device_ms {row['replayed']['device_ms']:.4f} host_ms "
              f"{row['replayed']['host_ms']:.4f} (busy "
              f"{row['replayed']['device_busy']:.3f}); eager device_ms "
              f"{row['eager']['device_ms']:.4f} host_ms "
              f"{row['eager']['host_ms']:.4f} (busy "
              f"{row['eager']['device_busy']:.3f})", flush=True)
        del pk, pv
    return out


def profile_decode(torch, run, args, gen, fname="decode_profile.txt"):
    """``--profile``: torch.profiler over three decode steps (or calls of
    another ``run``); writes the table by kernel to chiprun_out/``fname``
    and returns the device time per step summed over kernels (None when
    the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run(*args, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run(*args, gen)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_device_time_total", row_limit=40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", fname), "w") as fh:
        fh.write(table)
    # the device rows that the table's "Self CUDA time total" counts:
    # user annotations are device rows too, but span kernels counted
    # already
    dev_us = sum(e.self_device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation)
    print(table, flush=True)
    return dev_us / 3e3 if dev_us else None


TRAIN_B, TRAIN_L, TRAIN_STEPS = 8, 1024, 5
# launches per train step of gpt_like (12 layers): K1 forward, K1c and
# K1d once per layer, K3 once, K2 for ln1, ln2 of each layer and final_ln
TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                  "flash_attention_bwd_dkv": 12, "cross_entropy_lse": 1,
                  "layer_norm_fwd": 25, "paged_attention": 0,
                  "qkv_project": 0, "out_project": 0, "rms_norm_fwd": 0,
                  "rtc_row_absmax_scale": 0}


def kernel_wrappers():
    """name in the kernels line -> the wrapper that counts its launches"""
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import layer_norm as kln
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa
    from mxnet_tpu_torch.rtc import CudaKernel

    return {"layer_norm_fwd": kln.fused_layer_norm,
            "paged_attention": kpa.paged_attention_kernel,
            "qkv_project": kfd.fused_qkv_project,
            "out_project": kfd.fused_out_project,
            "flash_attention_fwd": kfa.flash_forward,
            "flash_attention_bwd_dq": kfa.flash_backward_dq,
            "flash_attention_bwd_dkv": kfa.flash_backward_dkv,
            "cross_entropy_lse": kce.fused_lse,
            "rms_norm_fwd": kln.fused_rms_norm,
            # every runtime-compiled kernel's launches (a class counter)
            "rtc_row_absmax_scale": CudaKernel}


def train_loss(model, tokens):
    """The next-token loss of the Gluon train loop, per sequence."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(model(tokens)[:, :-1],
                                         tokens[:, 1:])
    autograd.backward(loss)
    return loss.detach()


def train_grad_check(torch, model, dev, wrappers):
    """Phase 6: one full-width backward at B 2, L 1024 through the kernels
    and the same under ``no_kernels`` (the plain path: dense f32
    attention, plain LayerNorm and logsumexp) on the card. The losses
    agree to 1e-5 relative and each parameter's gradient to 1e-3 of its
    largest magnitude (f32 sums in another order through 12 layers and
    the 32000-way softmax); no kernel launches under ``no_kernels``; every
    LayerNorm gain gets a non-zero gradient through K2's backward. Then
    the same step under the default policy against the kernels' step
    (:func:`policy_diff`)."""
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops import nn as tnn

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    tokens = torch.randint(0, CFG["vocab_size"], (2, TRAIN_L),
                           generator=gen, device=dev)

    def grads():
        for w in wrappers.values():
            w.launches = 0
        loss = train_loss(model, tokens)
        out = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return loss, out, {k: w.launches for k, w in wrappers.items()}

    loss_k, grad_k, counts_k = grads()
    with tnn.no_kernels():
        loss_p, grad_p, counts_p = grads()
    check(counts_k == TRAIN_LAUNCHES,
          f"kernel step launched {counts_k} != {TRAIN_LAUNCHES}")
    check(not any(counts_p.values()), f"no_kernels launched {counts_p}")
    loss_err = (loss_k - loss_p).abs().max().item()
    check(loss_err <= 1e-5 * loss_p.abs().max().item(),
          f"train loss kernels vs plain: {loss_err}")
    worst, worst_name = 0.0, None
    for name, gp in grad_p.items():
        gk = grad_k[name]
        check(torch.isfinite(gk).all().item(), f"{name}: non-finite grad")
        ratio = ((gk - gp).abs().max() / gp.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
        if name.endswith(".gamma"):
            check(gk.abs().max().item() > 0, f"{name}: zero gradient")
    print(f"train step B2 L{TRAIN_L}, kernels vs no_kernels on the card: "
          f"loss {loss_k.tolist()} vs {loss_p.tolist()} (max err "
          f"{loss_err:.3e}); {len(grad_p)} gradients, worst max|err| / "
          f"max|g| {worst:.3e} ({worst_name}, limit 1e-3); all "
          f"{sum(n.endswith('.gamma') for n in grad_p)} LayerNorm gains "
          f"have non-zero gradients; kernel launches {counts_k}",
          flush=True)
    check(worst <= 1e-3, f"gradient {worst_name}: {worst} > 1e-3")
    with matmul_precision_scope("default"):
        loss_d, grad_d, counts_d = grads()
    policy = policy_diff(torch, "gpt_like B2", loss_d, grad_d, loss_k, grad_k)
    check(counts_d == TRAIN_LAUNCHES,
          f"default-policy step launched {counts_d} != {TRAIN_LAUNCHES}")
    return {"loss_err": loss_err, "worst_grad_ratio": worst,
            "worst_grad": worst_name, "launches": counts_k,
            "default_vs_highest": policy}


# The default policy's step (cuBLAS and K1 in one TF32 pass) against the
# "highest" step at the same weights and batch, as a share of the
# highest step's values. Each product's operands keep 10 mantissa bits
# (2^-11 relative rounding), so a matmul output is off by about 1e-3 of
# its magnitude; the loss, a mean over thousands of rows, moves far less
# (1e-3 relative leaves room), and the gradients carry the error
# through 12 layers forward and back and the 32000-way softmax: 5e-2 of
# each gradient's largest magnitude.
POLICY_LOSS_TOL, POLICY_GRAD_TOL = 1e-3, 5e-2


def policy_diff(torch, what, loss_d, grad_d, loss_h, grad_h):
    """Hold a default-policy step's loss and gradients against the
    highest-policy step's (``POLICY_LOSS_TOL``, ``POLICY_GRAD_TOL``)."""
    loss_err = ((loss_d - loss_h).abs().max()
                / loss_h.abs().max()).item()
    worst, worst_name = 0.0, None
    for name, gh in grad_h.items():
        gd = grad_d[name]
        check(torch.isfinite(gd).all().item(), f"{name}: non-finite grad")
        ratio = ((gd - gh).abs().max() / gh.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    print(f"{what}, the default policy (TF32) against highest at the same "
          f"weights: loss relative err {loss_err:.3e} (limit "
          f"{POLICY_LOSS_TOL:g}); {len(grad_h)} gradients, worst max|err| "
          f"/ max|g| {worst:.3e} ({worst_name}, limit {POLICY_GRAD_TOL:g})",
          flush=True)
    check(loss_err <= POLICY_LOSS_TOL, f"{what}: default-policy loss "
          f"{loss_err} from highest")
    check(worst <= POLICY_GRAD_TOL, f"{what}: default-policy gradient "
          f"{worst_name} {worst} from highest")
    return {"loss_rel_err": loss_err, "worst_grad_ratio": worst,
            "worst_grad": worst_name}


# Device time by kind. A kernel takes the kind of the outermost torch op
# above the one that launched it, where that op is a convolution (cuDNN
# runs 1x1 convolutions as GEMMs and its FFT algorithm as complex GEMMs,
# and transposes layouts, so a kernel's name does not tell) or a product
# (cuBLAS); else, by its name, a torch reduction (BatchNorm's var_mean
# and its backward sums, the loss's); the rest is elementwise work and
# copies. Each kind's top kernels are printed with it.
OP_KINDS = {"aten::convolution": "convolution",
            "aten::convolution_backward": "convolution",
            "aten::mm": "product", "aten::addmm": "product",
            "aten::bmm": "product", "aten::baddbmm": "product"}
REDUCE_KERNEL = re.compile(r"at::native::reduce_kernel")


def profile_train_step(torch, step, fname="train_profile.txt", named=None):
    """``--profile``: torch.profiler over one train step; writes the table
    by kernel to chiprun_out/``fname``, with each kind's top kernels.
    Returns (device ms summed over kernels, wall ms of the profiled
    step, device ms by kind: see :data:`OP_KINDS`). ``named`` maps more
    kinds to regular expressions of kernel names, which take a kernel
    before the op that launched it does (the port's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_device_time_total", row_limit=40)
    named = named or {}
    split = dict({kind: 0.0 for kind in named}, convolution=0.0,
                 product=0.0, reduction=0.0, other=0.0)
    by_kind = {kind: {} for kind in split}

    def walk(e, kind):
        kind = kind or OP_KINDS.get(e.name)
        for k in e.kernels:
            got = (next((n for n, pat in named.items()
                         if re.search(pat, k.name)), None) or kind
                   or ("reduction" if REDUCE_KERNEL.search(k.name)
                       else "other"))
            split[got] += k.duration / 1e3
            by_kind[got][k.name] = by_kind[got].get(k.name, 0.0) \
                + k.duration / 1e3
        for child in e.cpu_children:
            walk(child, kind)

    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            walk(e, None)
    total = sum(e.self_device_time_total for e in avgs
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation) / 1e3
    attributed = sum(split.values())
    # kernels no op launched (none expected) count as other
    split["other"] += max(total - attributed, 0.0)
    tops = [f"device ms {total:.3f}, {attributed:.3f} of it under a torch op"]
    for kind, rows in by_kind.items():
        tops.append(f"{kind}: {split[kind]:.3f} ms over {len(rows)} kernels")
        tops += [f"  {ms:9.3f} ms  {name[:140]}" for name, ms in
                 sorted(rows.items(), key=lambda r: -r[1])[:6]]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", fname), "w") as fh:
        fh.write(table + "\n" + "\n".join(tops) + "\n")
    print(table, flush=True)
    print("\n".join(tops), flush=True)
    return (total if total else None), wall_ms, split


def train_phase(torch, model, dev, card, wrappers, profile, policy):
    """Phase 7: gpt_like trains at full width through
    SoftmaxCrossEntropyLoss and Trainer (SGD, momentum 0.9, lr 0.01) on
    one seeded batch of 8 x 1024 tokens, run by the caller under the
    matmul ``policy`` (named in the results): one warm-up step, then 5
    timed steps with exact launch counts and a falling loss."""
    from mxnet_tpu_torch.gluon import Trainer

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    tokens = torch.randint(0, CFG["vocab_size"], (TRAIN_B, TRAIN_L),
                           generator=gen, device=dev)
    trainer = Trainer(dict(model.named_parameters()), "sgd",
                      {"learning_rate": 0.01, "momentum": 0.9})

    def step():
        loss = train_loss(model, tokens)
        trainer.step(TRAIN_B)
        return loss

    first = step().mean().item()                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    losses, host_ms, span_ms = [], [], []
    for _ in range(TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
        losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = {k: TRAIN_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and np.isfinite(first),
          f"non-finite loss {first} {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses}")
    check(counts == want, f"train launches {counts} != {want}")
    step_ms = float(np.mean(host_ms))
    out = {"batch": TRAIN_B, "seq": TRAIN_L, "warmup_loss": first,
           "losses": losses, "host_ms": host_ms, "device_span_ms": span_ms,
           "step_ms": step_ms, "tok_s": TRAIN_B * TRAIN_L / step_ms * 1e3,
           "max_memory_allocated": peak, "launches": counts, "card": card,
           "policy": policy}
    print(f"train on {card}, matmul precision {policy}: gpt_like {CFG} "
          f"B{TRAIN_B} L{TRAIN_L} SGD "
          f"momentum 0.9 lr 0.01; loss {first:.5f} (warm-up) -> "
          f"{[round(x, 5) for x in losses]}; step ms (host wall to a "
          f"synchronise) {[round(x, 3) for x in host_ms]}, device span ms "
          f"(CUDA events) {[round(x, 3) for x in span_ms]}; "
          f"{out['tok_s']:.1f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB; launches over {TRAIN_STEPS} steps "
          f"{counts}", flush=True)
    if profile:
        dev_ms, wall_ms, _ = profile_train_step(
            torch, step, f"train_profile_{policy}.txt")
        out["profile"] = {"device_ms": dev_ms, "wall_ms": wall_ms}
        print(f"train step, profiler: device ms summed over kernels "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'}, "
              f"wall ms {wall_ms:.3f}"
              + ("" if dev_ms is None else
                 f", device busy {dev_ms / wall_ms:.3f}"), flush=True)
    return out


# -- phase 9: the ResNet path ------------------------------------------------
# ResNet-50 v1 at the repo's flagship settings: classes 1000, 224x224,
# batch 32 (bench.py:291, __graft_entry__.py:36), trained by SGD with
# momentum 0.9 and lr 0.05 on uniform [0, 1) images and random labels
# (benchmark/train_bench.py:46-131)
RN_B, RN_HW, RN_CLASSES = 32, 224, 1000
RN_ITERS, RN_STEPS = 20, 5
# BASELINE.md's V100 rows at batch 32 (MXNet 1.2.0, cuDNN 7.0.5): the
# published yardstick, not numbers of this card
V100_IMG_S = {"inference f32": 1076.81, "inference fp16": 2085.51,
              "training f32": 298.51}
# Tolerances of phase 9, as a share of the reference logits' largest
# magnitude. The card under highest against the port on the CPU: both
# IEEE f32, sums in another order through 54 layers. The default
# policy against highest: TF32 operands (10 mantissa bits) in every
# convolution and the classifier; rounding both operands of each to
# TF32 on the CPU moved the logits by 2.9e-4 of their largest magnitude
# at these weights (B 2, 224x224), and 5e-3 leaves 17x for cuDNN's own
# algorithms. bfloat16 parameters and activations against f32: 5.3e-3
# on the CPU the same way, 3e-2 leaves 5.7x.
RN_CPU_TOL, RN_POLICY_TOL, RN_BF16_TOL = 1e-4, 5e-3, 3e-2


def resnet_weights(net, seed):
    """Numpy weights under the reference's names, in the shapes a forward
    completed: convolution weights uniform in [-0.07, 0.07) (the scale of
    both packages' default initializer), the classifier's normal with
    std 0.01, BatchNorm gains and running variances in [1, 1.2) but the
    gain that closes each residual body ten times smaller (a small-gain
    residual start, as Goyal et al. 2017 zero it), the rest normal with
    std 0.1. With the body gains at 1 the residual sums grow over the 16
    blocks, and SGD at lr 0.05 with momentum 0.9 climbs after two steps
    (a CPU run at B 32, 64x64: 9.09 -> 5.07 -> 15.77 in 6 steps); with
    them small it falls (6.97 -> 0.39)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in net.collect_params().items():
        shape = tuple(p.shape)
        if name == "output.weight":
            out[name] = rng.standard_normal(shape, dtype=np.float32) * \
                np.float32(0.01)
        elif name.endswith("weight"):
            out[name] = (rng.random(shape, dtype=np.float32) - 0.5) * \
                np.float32(0.14)
        elif name.endswith(("gamma", "running_var")):
            out[name] = 1 + 0.2 * rng.random(shape, dtype=np.float32)
            if name.endswith("body.7.gamma"):
                out[name] *= np.float32(0.1)
        else:
            out[name] = 0.1 * rng.standard_normal(shape, dtype=np.float32)
    return out


def resnet_macs(torch, net, x):
    """Multiply-adds per image of one forward, from the convolution and
    Dense layers' output and weight shapes (forward hooks)."""
    from mxnet_tpu_torch.gluon import nn

    macs = []

    def hook(block, inputs, out):
        macs.append(out[0].numel() * block.weight.data()[0].numel())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (nn.Conv2D, nn.Dense))]
    with torch.no_grad():
        net(x[:1])
    for h in handles:
        h.detach()
    return sum(macs), len(macs)


def resnet_inference(torch, net, x, card, what, macs, label="resnet50_v1",
                     iters=RN_ITERS):
    """One inference mode of phase 9 (``what``) of the net ``label``
    (phase 12 runs the other vision nets through it): the block eager,
    then hybridized. The first hybridized call captures a CUDA graph and
    the second replays it; the replay must equal the eager call bitwise,
    and still equal it after a replay on other inputs (the block returns
    copies of the graph's static outputs).
    Then each is timed over ``iters`` calls (``time_ms``): img/s from the
    host ms per call (a loop that ends in a synchronise), the device ms
    per call behind a spin kernel, the busy share."""
    batch, size = x.shape[0], x.shape[-1]
    net.hybridize(False)
    with torch.no_grad():
        eager = net(x)
        eager_t = time_ms(lambda i: net(x), iters=iters, warmup=2)
    net.hybridize()
    t0 = time.perf_counter()
    net(x)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay = net(x)
    check(net.captures == 1 and net.replays == 2,
          f"{label} {what}: {net.captures} captures, {net.replays} replays")
    check(torch.equal(replay, eager), f"{label} {what}: a replay differs "
          f"from the eager call by {(replay - eager).abs().max().item()}")
    replay_t = time_ms(lambda i: net(x), iters=iters, warmup=2)
    check(net.captures == 1, f"{label} {what}: captured again while timing")
    other = net(x.flip(0))          # the same graph, other logits
    check(not torch.equal(other, replay) and torch.equal(replay, eager),
          f"{label} {what}: logits kept from a replay changed under a "
          "later replay (not a copy of the graph's output)")
    row = {"capture_s": capture_s, "replay_equals_eager": True}
    for mode, (dev_ms, host_ms) in (("eager", eager_t),
                                     ("replayed", replay_t)):
        row[mode] = {"device_ms": dev_ms, "host_ms": host_ms,
                     "img_s": batch / host_ms * 1e3,
                     "device_busy": dev_ms / host_ms}
        print(f"{label} inference {what} on {card}, {mode}: "
              f"{row[mode]['img_s']:.1f} img/s (B{batch}, {size}x{size}, "
              f"mean of {iters} calls), host_ms {host_ms:.4f}, "
              f"device_ms {dev_ms:.4f}, device busy "
              f"{dev_ms / host_ms:.3f}; {2 * macs * batch / dev_ms / 1e9:.1f}"
              f" TFLOP/s on the layers' multiply-adds", flush=True)
    print(f"{label} inference {what}: one replay equals one eager call "
          f"bitwise; capture and first replay {capture_s:.3f} s", flush=True)
    return row, eager


def train_mode_replay(torch, net, weights, x):
    """A hybridized call in training mode, not recording (batch
    statistics, running statistics moved in place): its first call
    captures and replays once, and must give the eager call's output and
    statistics bitwise, from the same seeded statistics (the capture's
    warm-up run leaves them as it found them); a second call moves them
    again. It leaves the net with the seeded weights and statistics."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import from_jax_params

    stats = [p.data() for n, p in net.collect_params().items()
             if n.endswith(("running_mean", "running_var"))]
    outs = []
    for active in (False, True):
        from_jax_params(weights, net)
        net.hybridize(active)
        with torch.no_grad(), autograd.train_mode():
            outs.append((net(x), [t.clone() for t in stats]))
    check(net.captures == 1 and net.replays == 1,
          f"training-mode call: {net.captures} captures, {net.replays} "
          "replays")
    (eager, eager_stats), (replay, replay_stats) = outs
    check(torch.equal(replay, eager)
          and all(torch.equal(a, b) for a, b in zip(replay_stats,
                                                    eager_stats)),
          "a training-mode replay differs from the eager call")
    with torch.no_grad(), autograd.train_mode():
        net(x)
    check(net.replays == 2 and not torch.equal(stats[0], eager_stats[0]),
          "the second training-mode replay did not move the statistics")
    net.hybridize(False)
    from_jax_params(weights, net)       # the seeded statistics again
    print("resnet50_v1 hybridized in training mode (not recording): the "
          "capturing call equals the eager call bitwise, its output and all "
          f"{len(stats)} running statistics (moved once); the next replay "
          "moves them again", flush=True)


def resnet_grads(torch, net, weights, x, y):
    """A train-mode forward and backward from the seeded weights and
    statistics: (per-example loss, name -> gradient)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    from_jax_params(weights, net)
    params = net.collect_params()
    with autograd.record():
        loss = SoftmaxCrossEntropyLoss()(net(x), y)
    autograd.backward(loss)
    grads = {n: p.grad().clone() for n, p in params.items()
             if p.grad_req != "null"}
    net.zero_grad(set_to_none=True)
    return loss.detach(), grads


def resnet_train(torch, net, weights, x, y, card, wrappers, macs, policy,
                 profile):
    """Phase 9's train steps under ``policy`` (set by the caller), from
    the seeded weights and statistics: SoftmaxCrossEntropyLoss and
    ``Trainer(net.collect_params(), "sgd", lr 0.05, momentum 0.9)``. In
    the warm-up step, the parameters whose grad_req is null (the
    BatchNorm statistics) move in the forward and not in the Trainer's
    step. Then RN_STEPS timed steps: the loss falls below the warm-up's,
    every running statistic has moved from its seeded value, the
    hybridized block replays its recorded forward and backward graphs
    once a step (the warm-up step captured them), and the only kernel of
    the port launched is K3, once per step (the loss)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    dev = x.device
    from_jax_params(weights, net)
    params = net.collect_params()
    stats = {n: p for n, p in params.items() if p.grad_req == "null"}
    check(len(stats) == 106 and all(n.endswith(("running_mean",
                                                "running_var"))
                                    for n in stats),
          f"grad_req null: {sorted(stats)[:4]}... ({len(stats)})")
    trainer = Trainer(params, "sgd", {"learning_rate": 0.05,
                                      "momentum": 0.9})
    loss_fn = SoftmaxCrossEntropyLoss()

    def forward_backward():
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        return loss.detach()

    def step():
        loss = forward_backward()
        trainer.step(RN_B)
        return loss

    first = forward_backward().mean().item()          # the warm-up step
    graphs = (net.captures, net.replays)
    moved = {n: p.data().clone() for n, p in stats.items()}
    trainer.step(RN_B)
    check(all(torch.equal(p.data(), moved[n]) for n, p in stats.items()),
          "the Trainer changed a parameter whose grad_req is null")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    losses, host_ms, span_ms = [], [], []
    for _ in range(RN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
        losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers}, cross_entropy_lse=RN_STEPS)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and np.isfinite(first),
          f"non-finite loss {first} {losses}")
    check(losses[-1] < first, f"loss did not fall: {first} -> {losses}")
    check(counts == want, f"ResNet train launches {counts} != {want}")
    check((net.captures, net.replays) == (graphs[0], graphs[1] + RN_STEPS),
          f"recorded graphs {graphs} -> {(net.captures, net.replays)} "
          f"over {RN_STEPS} steps")
    still = [n for n, p in stats.items()
             if torch.equal(p.data().cpu(), torch.from_numpy(weights[n]))]
    check(not still, f"running statistics that did not move: {still[:4]}")
    step_ms = float(np.mean(host_ms))
    out = {"warmup_loss": first, "losses": losses, "host_ms": host_ms,
           "device_span_ms": span_ms, "step_ms": step_ms,
           "img_s": RN_B / step_ms * 1e3, "max_memory_allocated": peak,
           "launches": counts, "policy": policy}
    print(f"resnet50_v1 train on {card}, matmul precision {policy}: B{RN_B} "
          f"{RN_HW}x{RN_HW} SGD momentum 0.9 lr 0.05, "
          f"SoftmaxCrossEntropyLoss; loss {first:.5f} (warm-up) -> "
          f"{[round(v, 5) for v in losses]}; step ms (host wall to a "
          f"synchronise) {[round(v, 3) for v in host_ms]}, device span ms "
          f"(CUDA events) {[round(v, 3) for v in span_ms]}; "
          f"{out['img_s']:.1f} img/s; {6 * macs * RN_B / step_ms / 1e9:.1f} "
          f"TFLOP/s on 3x the forward's multiply-adds; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; launches over "
          f"{RN_STEPS} steps {counts}; all {len(stats)} running statistics "
          f"moved, none by the Trainer", flush=True)
    if profile:
        dev_ms, wall_ms, split = profile_train_step(
            torch, step, f"resnet_train_profile_{policy}.txt")
        check(dev_ms is not None, "the profiler saw no device time")
        out["profile"] = {"device_ms": dev_ms, "wall_ms": wall_ms,
                          "by_kind_ms": split}
        print(f"resnet50_v1 train step ({policy}), profiler: device ms "
              f"summed over kernels {dev_ms:.3f}, wall ms {wall_ms:.3f}, "
              f"device busy {dev_ms / wall_ms:.3f}; device ms by kind "
              f"{ {k: round(v, 3) for k, v in split.items()} }", flush=True)
    return out


# A B 4 train step's gradients, per parameter, as ||err|| / ||g|| (the
# Frobenius norm). The per-entry max measure of the other paths does not
# hold here: IEEE f32 on the card against IEEE f32 on the CPU already
# differ by up to 6.8e-2 of a gradient's largest entry (measured on one
# H100), since each weight gradient of a random ResNet is a sum of ~10^3
# to 10^5 products that nearly cancel, so a sum's error is its terms'
# rounding times a large cancellation factor. In norm the card and the
# CPU differ by at most 8.0e-3 there; 2e-2 is the limit. The default
# policy rounds every convolution's operands to TF32 (2^-11) in the
# forward and in both backward products: 6.9e-2 to 1.16e-1 per
# parameter at B 4, 8, 16 and 32 alike, 1.9e-2 over all parameters
# together (measured on one H100). The limits, 0.25 per parameter and
# 5e-2 over all, hold the default policy to that error model with 2x
# room; a wrong gradient (a layer's missing, a sign, a transposed
# weight) is off by ~1. The losses agree to POLICY_LOSS_TOL (1e-3)
# across policies and to 1e-5 across devices.
RN_CPU_GRAD_TOL, RN_TF32_GRAD_TOL, RN_TF32_GLOBAL_TOL = 2e-2, 0.25, 5e-2


def resnet_grad_checks(torch, net, cpu, weights, x, y):
    """A B 4 train step from the seeded weights and statistics on the card
    under highest, under default, and on the CPU (IEEE f32): the losses
    and each parameter's gradient held to each other in norm, with the
    limits above."""
    from mxnet_tpu_torch.base import matmul_precision_scope

    with matmul_precision_scope("highest"):
        loss_h, grad_h = resnet_grads(torch, net, weights, x, y)
    with matmul_precision_scope("default"):
        loss_d, grad_d = resnet_grads(torch, net, weights, x, y)
    loss_c, grad_c = resnet_grads(torch, cpu, weights, x.cpu(), y.cpu())
    return {
        "default vs highest": grads_in_norm(
            torch, "resnet50_v1 B4 gradients, default vs highest",
            (loss_d, grad_d), (loss_h, grad_h), POLICY_LOSS_TOL,
            RN_TF32_GRAD_TOL, RN_TF32_GLOBAL_TOL),
        "card highest vs CPU": grads_in_norm(
            torch, "resnet50_v1 B4 gradients, card highest vs CPU",
            (loss_h.cpu(), {n: g.cpu() for n, g in grad_h.items()}),
            (loss_c, grad_c), 1e-5, RN_CPU_GRAD_TOL, RN_CPU_GRAD_TOL)}


def grads_in_norm(torch, what, a, b, loss_tol, tol, global_tol):
    """Hold step ``a``'s (loss, name -> gradient) to step ``b``'s: the
    loss to ``loss_tol`` relative, each gradient to ``tol`` as
    ||err|| / ||g||, and all of them together to ``global_tol``."""
    (la, ga), (lb, gb) = a, b
    for g in ga.values():
        check(torch.isfinite(g).all().item(), f"{what}: non-finite grad")
    loss_err = ((la - lb).abs().max() / lb.abs().max()).item()
    ratios = sorted((((ga[n] - g).norm() / g.norm()).item(), n)
                    for n, g in gb.items())
    flat = [torch.cat([d[n].flatten().cpu() for n in gb]) for d in (ga, gb)]
    overall = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    print(f"{what}: loss relative err {loss_err:.3e} (limit {loss_tol:g}); "
          f"{len(ratios)} gradients, ||err|| / ||g|| worst "
          f"{ratios[-1][0]:.3e} ({ratios[-1][1]}, limit {tol:g}), median "
          f"{ratios[len(ratios) // 2][0]:.3e}, over all parameters "
          f"{overall:.3e} (limit {global_tol:g})", flush=True)
    check(loss_err <= loss_tol, f"{what}: loss {loss_err}")
    check(ratios[-1][0] <= tol and overall <= global_tol,
          f"{what}: {ratios[-1]}, {overall}")
    return {"loss_rel_err": loss_err, "worst": ratios[-1],
            "median": ratios[len(ratios) // 2][0], "all_parameters": overall}


def resnet_phase(torch, card, wrappers, profile):
    """Phase 9: ResNet-50 v1, the repo's flagship entry, on the card
    through the user's entry points: ``vision.get_model("resnet50_v1",
    classes=1000)``, ``initialize()`` (gpu(0)), a forward that completes
    the deferred shapes, seeded weights through ``from_jax_params``.
    Inference at B 32, 224x224, eager and hybridized (graph replay)
    under highest, then default, then in bfloat16 after
    ``net.cast("bfloat16")`` under default; the card's highest logits
    against the port on the CPU, default and bfloat16 against highest,
    ``functionalize`` against the block, bitwise, leaving its params
    unchanged. Then training (:func:`resnet_train`) under each policy,
    and a B 4 step's loss and gradients under default against highest
    and on the card against the CPU (:func:`resnet_grad_checks`).
    Nothing of it is caught."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo import vision

    t_phase = time.perf_counter()
    dev = mx.context.resolve_device(None)
    net = vision.get_model("resnet50_v1", classes=RN_CLASSES)
    net.initialize()                                  # gpu(0)
    deferred = sum(not p.initialized for p in net.collect_params().values())
    rng = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(rng.random((RN_B, 3, RN_HW, RN_HW),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, RN_CLASSES, RN_B)).to(dev)
    with autograd.pause():
        net(x[:1])                                    # completes the shapes
    weights = resnet_weights(net, SEED)
    from_jax_params(weights, net)
    params = net.collect_params()
    n_params = sum(p.data().numel() for p in params.values())
    macs, layers = resnet_macs(torch, net, x)
    print(f"resnet50_v1: {len(params)} parameters ({deferred} deferred "
          f"before the first forward), {n_params} values on "
          f"{params['output.weight'].data().device}; {macs} multiply-adds "
          f"per image over {layers} convolution and Dense layers", flush=True)
    out = {"batch": RN_B, "size": RN_HW, "params": n_params,
           "macs_per_image": macs, "card": card,
           "v100_yardstick_img_s": V100_IMG_S}

    # inference: highest, default, then bfloat16 --------------------------
    logits = {}
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            out[f"infer_{policy}"], logits[policy] = resnet_inference(
                torch, net, x, card, f"f32 {policy}", macs)
    with matmul_precision_scope("highest"):
        net.hybridize(False)
        fn, fparams = net.functionalize(x)
        before = {n: t.clone() for n, t in fparams.items()}
        # the classifier's weight zeroed in the caller's params, not in
        # the block: fn's logits are then its bias, exactly
        zeroed = {**fparams, "output.weight": torch.zeros_like(
            fparams["output.weight"])}
        with torch.no_grad():
            fout, _ = fn(fparams, x)
            zout, _ = fn(zeroed, x)
            tfn, tparams = net.functionalize(x, training=True)
            _, tnew = tfn(tparams, x)
    check(torch.equal(fout, logits["highest"]),
          "functionalize's fn differs from the block")
    check(torch.equal(zout, fparams["output.bias"].expand_as(zout)),
          "functionalize's fn did not compute with the params it was given")
    check(all(torch.equal(t, before[n]) for n, t in fparams.items()),
          "functionalize's fn changed its params")
    check(all(torch.equal(t, before[n]) for n, t in tparams.items()),
          "a training-mode fn changed its params")
    check(not torch.equal(tnew["features.1.running_mean"],
                          before["features.1.running_mean"]),
          "a training-mode fn returned unmoved statistics")
    print("functionalize: fn(params, x) equals the block's logits bitwise "
          "(eval, highest) and leaves params unchanged; given a zero "
          "classifier weight, its logits are the bias; a training-mode fn "
          "returns moved statistics and leaves its params unchanged",
          flush=True)
    del before, fparams, zeroed, tparams, tnew
    with matmul_precision_scope("highest"):
        train_mode_replay(torch, net, weights, x)

    cpu = vision.resnet50_v1(classes=RN_CLASSES)
    cpu.initialize(device="cpu")
    with torch.no_grad():
        cpu(x[:1].cpu())
        from_jax_params(weights, cpu)
        ref = cpu(x[:2].cpu())
    scale = ref.abs().max().item()
    errs = {"card highest vs CPU (B 2)":
            ((logits["highest"][:2].cpu() - ref).abs().max().item(), scale,
             RN_CPU_TOL)}
    ref = logits["highest"]
    scale = ref.abs().max().item()
    errs["default vs highest"] = (
        (logits["default"] - ref).abs().max().item(), scale, RN_POLICY_TOL)

    net.cast("bfloat16")
    with matmul_precision_scope("default"):
        out["infer_bfloat16"], logits["bfloat16"] = resnet_inference(
            torch, net, x.bfloat16(), card, "bfloat16 default", macs)
    errs["bfloat16 vs f32 highest"] = (
        (logits["bfloat16"].float() - ref).abs().max().item(), scale,
        RN_BF16_TOL)
    net.hybridize(False)
    net.cast("float32")
    for name, lg in logits.items():
        check(lg.shape == (RN_B, RN_CLASSES)
              and torch.isfinite(lg).all().item(),
              f"{name} logits: shape {tuple(lg.shape)} or non-finite")
    for what, (err, mag, tol) in errs.items():
        agree = (logits[what.split()[0]].argmax(-1) == ref.argmax(-1)
                 ).float().mean().item() if what[:4] != "card" else None
        print(f"resnet50_v1 logits, {what}: max|err| {err:.4e}, "
              f"{err / mag:.3e} of the largest magnitude {mag:.4e} (limit "
              f"{tol:g}); argmax agreement {agree}", flush=True)
        check(err <= tol * mag, f"resnet50_v1 logits {what}: {err} > "
              f"{tol} x {mag}")
    out["logits_err"] = {k: {"max_abs_err": e, "scale": m, "tol": t}
                         for k, (e, m, t) in errs.items()}
    del logits

    # training under each policy ------------------------------------------
    net.hybridize()
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            out[f"train_{policy}"] = resnet_train(
                torch, net, weights, x, y, card, wrappers, macs, policy,
                profile)
    out["gradients_b4"] = resnet_grad_checks(torch, net, cpu, weights, x[:4],
                                             y[:4])
    out["seconds"] = time.perf_counter() - t_phase
    replayed = {k: out[f"infer_{k}"]["replayed"]["img_s"]
                for k in ("highest", "default", "bfloat16")}
    print(f"yardstick, BASELINE.md's V100 rows at batch 32 (MXNet 1.2.0, "
          f"published): inference f32 {V100_IMG_S['inference f32']} img/s, "
          f"fp16 {V100_IMG_S['inference fp16']}, training f32 "
          f"{V100_IMG_S['training f32']}; this card ({card}): inference "
          f"replayed f32 highest {replayed['highest']:.1f}, default "
          f"{replayed['default']:.1f}, bfloat16 {replayed['bfloat16']:.1f}; "
          f"training highest {out['train_highest']['img_s']:.1f}, default "
          f"{out['train_default']['img_s']:.1f}; phase 9 took "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# -- phase 10: speculative decoding and the shared-prefix block cache -------
# benchmark/llm_serve_bench.py:289-358's spec_prefix rows at their full
# (non-quick) settings, with the full-width gpt_like as the target: 48
# requests, each one shared 448-token prefix (28 blocks of 16) and a
# unique tail, (tail, max_new) cycling SPEC_CONFIGS; 16 lanes, block 16,
# int8 KV, draft_k 3. The target's layers >= 1 have their residual
# branches scaled by SPEC_ALPHA (the bench's damp_upper_layers), so that
# a 1-layer draft holding the target's embeddings and layer 0 (its
# make_draft) proposes as a distilled draft would; the acceptance rate
# is measured
SPEC_LANES, SPEC_K, SPEC_BS, SPEC_PREFIX = 16, 3, 16, 448
SPEC_CONFIGS = ((4, 16), (12, 24), (20, 12), (8, 16))
SPEC_REQUESTS, SPEC_PRIME, SPEC_ALPHA = 48, 8, 0.05
SPEC_MAX_CONTEXT = (SPEC_PREFIX + 2 * SPEC_BS
                    + max(n for _, n in SPEC_CONFIGS) + SPEC_K)


def spec_lane_positions():
    """Write positions of the 16 verify lanes: the prefix, each lane's
    tail (cycling SPEC_CONFIGS) and a few tokens generated."""
    return [SPEC_PREFIX + SPEC_CONFIGS[i % 4][0] + i % 7
            for i in range(SPEC_LANES)]


def spec_shape_checks(torch, dev, floor_ms):
    """Phase 2, the shapes phase 10 gives K4, K5a and K5b: the verify
    forward's N = 16 lanes x (K+1) = 64 rows and the 32-token suffix
    bucket's N = 32, and K4 over the verify's 64 virtual lanes. K5a and
    K5b give the plain version's outputs byte for byte on exact inputs
    (and K5a the rounding probe's rows), then are timed on random inputs
    with one weight set per layer beside ``F.linear`` at the same N (for
    K5a the three products of Q, K and V in one); K4 holds to 1e-4 and
    is timed. Returns the rows."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 13)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def dyadic(*shape, denom):
        return torch.randint(-4, 5, shape, generator=g, device=dev) / denom

    rows, u, heads, d, bs, n_sets = [], 768, 12, 64, SPEC_BS, 12
    for n in (SPEC_LANES * (SPEC_K + 1), 32):
        what = "verify" if n == SPEC_LANES * (SPEC_K + 1) else "suffix"
        xx, ww, bb = (dyadic(n, u, denom=4), dyadic(3 * u, u, denom=64),
                      dyadic(3 * u, denom=4))
        off = [int((a_ != b_).sum().item()) for a_, b_ in zip(
            kfd.fused_qkv_project(xx, ww, bb, heads=heads,
                                  store_dtype=torch.int8),
            kfd.qkv_project_plain(xx, ww, bb, heads, torch.int8))]
        aa, wo_, bo_ = (dyadic(n, u, denom=4), dyadic(u, u, denom=64),
                        dyadic(u, denom=4))
        off_out = int((kfd.fused_out_project(aa, wo_, bo_)
                       != kfd.out_project_plain(aa, wo_, bo_)).sum().item())
        print(f"qkv_project N{n} ({what}) dyadic inputs: q, K and V "
              f"differing from the plain version in {off} elements; "
              f"out_project N{n}: {off_out} (must be 0)", flush=True)
        check(off == [0, 0, 0] and off_out == 0,
              f"N{n}: K5a {off}, K5b {off_out} elements differ")
        rounding_probe_check(torch, dev, u, heads, n)
        del xx, ww, bb, aa, wo_, bo_
        x = randn(n, u)
        wq = [randn(3 * u, u, scale=0.02) for _ in range(n_sets)]
        bq = [randn(3 * u, scale=0.02) for _ in range(n_sets)]
        got = kfd.fused_qkv_project(x, wq[0], bq[0], heads=heads,
                                    store_dtype=torch.int8)
        want = kfd.qkv_project_plain(x, wq[0], bq[0], heads, torch.int8)
        err = (got[0] - want[0]).abs().max().item()
        for a_, b_ in zip(got[1:], want[1:]):
            steps = (a_[..., :d].int() - b_[..., :d].int()).abs().max()
            check(steps.item() <= 1, f"qkv_project N{n}: int8 values more "
                  "than one step apart")
            err = max(err, (tnn.kv_cache_dequantize(a_, torch.float32)
                            - tnn.kv_cache_dequantize(b_, torch.float32))
                      .abs().max().item())
        rows.append(measure(
            "qkv_project", f"N{n} ({what}) U{u} H{heads} int8 store", err,
            # as at N 8: f32 sums in another order, int8 one step apart
            0.05,
            lambda i: kfd.fused_qkv_project(x, wq[i], bq[i], heads=heads,
                                            store_dtype=torch.int8),
            lambda i: kfd.qkv_project_plain(x, wq[i], bq[i], heads,
                                            torch.int8),
            lambda i: F.linear(x, wq[i], bq[i]),
            4 * (3 * u * u + 3 * u + 2 * n * u) + 2 * n * heads * (d + 4),
            2 * n * 3 * u * u, n_inputs=n_sets))
        rows[-1].update(launch_floor_ms=floor_ms, elements_off=off)
        del wq, bq, got, want
        a = randn(n, u)
        wo = [randn(u, u, scale=0.02) for _ in range(n_sets)]
        bo = [randn(u, scale=0.02) for _ in range(n_sets)]
        err = (kfd.fused_out_project(a, wo[0], bo[0])
               - kfd.out_project_plain(a, wo[0], bo[0])).abs().max().item()
        rows.append(measure(
            "out_project", f"N{n} ({what}) U{u}", err, 1e-4,
            lambda i: kfd.fused_out_project(a, wo[i], bo[i]),
            lambda i: kfd.out_project_plain(a, wo[i], bo[i]),
            lambda i: F.linear(a, wo[i], bo[i]),
            4 * (u * u + u + 2 * n * u), 2 * n * u * u, n_inputs=n_sets))
        rows[-1].update(launch_floor_ms=floor_ms, elements_off=off_out)
        for r_ in rows[-2:]:
            print(f"{r_['name']} {r_['case']}: kernel {r_['ms']:.5f} ms, "
                  f"F.linear {r_['library_ms']:.5f} ms "
                  f"({r_['library_ms'] / r_['ms']:.2f}x the kernel's time)",
                  flush=True)
        del wo, bo

    # K4 over the verify's 64 virtual lanes: every lane's table starts
    # with the 28 shared prefix blocks, then blocks of its own; lane r's
    # token t attends positions[r] + t + 1
    mb = -(-SPEC_MAX_CONTEXT // bs)
    shared = SPEC_PREFIX // bs
    own = torch.randperm(SPEC_LANES * (mb - shared), generator=g,
                         device=dev) + shared
    table = torch.cat([torch.arange(shared, device=dev).expand(
        SPEC_LANES, shared), own.reshape(SPEC_LANES, -1)], 1)
    table = table.to(torch.int32).repeat_interleave(SPEC_K + 1, 0)
    pos = spec_lane_positions()
    lens = [p_ + t + 1 for p_ in pos for t in range(SPEC_K + 1)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    nb = shared + SPEC_LANES * (mb - shared) + 1
    pools = []                          # one pool per layer, as in verify
    for _ in range(CFG["num_layers"]):
        kp, vp = (tnn.kv_cache_quantize(randn(nb, heads, bs, d))
                  for _ in range(2))
        pools.append((kp.contiguous(), vp.contiguous()))
    q = randn(len(lens), heads, d)
    kp, vp = pools[0]
    out = kpa.paged_attention_kernel(q, kp, vp, table, lengths)
    ref = kpa.paged_attention_plain(q, kp, vp, table, lengths)
    check(torch.isfinite(out).all().item(), "paged_attention verify shape: "
          "non-finite output")
    tab = table.cpu().numpy()
    live = {(int(tab[i, p_ // bs]), p_ % bs)
            for i, n_ in enumerate(lens) for p_ in range(n_)}
    row_bytes = kp.shape[-1] * kp.element_size()
    nbytes = (2 * len(live) * heads * row_bytes + 2 * len(lens) * heads * d * 4
              + 4 * len({(i // (SPEC_K + 1), c) for i, n_ in enumerate(lens)
                         for c in range(-(-n_ // bs))}) + 4 * len(lens))
    rows.append(measure(
        "paged_attention",
        f"{len(lens)} virtual lanes (verify: {SPEC_LANES} lanes x K+1) H"
        f"{heads} D{d} bs{bs} MB{mb} int8 pools, the 28 prefix blocks "
        f"shared, lengths {min(lens)}..{max(lens)}",
        (out - ref).abs().max().item(), 1e-4,
        lambda i: kpa.paged_attention_kernel(q, pools[i][0], pools[i][1],
                                             table, lengths),
        lambda i: kpa.paged_attention_plain(q, pools[i][0], pools[i][1],
                                            table, lengths),
        None, nbytes, 4 * sum(lens) * heads * d, n_inputs=len(pools)))
    rows[-1].update(unique_live_rows=len(live))
    del pools
    return rows


def spec_models(torch):
    """Phase 10's target (phase 3's seeded gpt_like with its upper layers'
    residual branches scaled by SPEC_ALPHA) and its 1-layer draft (the
    target's parameters of the same name and shape)."""
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like

    target = gpt_like(**CFG)
    params = seeded_params(target, SEED)
    for i in range(1, CFG["num_layers"]):
        for leaf in ("attn.out_proj.weight", "attn.out_proj.bias",
                     "ffn.ffn_2.weight", "ffn.ffn_2.bias"):
            params[f"encoder.layer{i}.{leaf}"] *= np.float32(SPEC_ALPHA)
    from_jax_params(params, target)
    draft = gpt_like(**dict(CFG, num_layers=1))
    from_jax_params({k: params[k] for k in draft.state_dict()}, draft)
    return target, draft


def spec_workload(rng, shared, n):
    """``n`` requests: the shared prefix and a tail of each config's
    length, cycling SPEC_CONFIGS."""
    out = []
    for i in range(n):
        tail, new = SPEC_CONFIGS[i % len(SPEC_CONFIGS)]
        out.append((np.concatenate([shared, rng.integers(
            0, CFG["vocab_size"], tail).astype(np.int32)]), new))
    return out


def spec_serve(torch, eng, reqs, prime, wrappers):
    """Warm ``eng`` on the workload's prompt lengths, serve ``prime``
    untimed (captures the suffix buckets, fills the cache), then time
    ``reqs`` submitted together. Returns the tokens, the wall seconds,
    the launches and the stats before and after the timed run."""
    eng.warmup(sorted({len(p) for p, _ in reqs}))
    for h in [eng.submit(p, n) for p, n in prime]:
        h.wait(timeout=600)
    before = eng.stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    outs = [h.wait(timeout=600) for h in [eng.submit(p, n)
                                          for p, n in reqs]]
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    return outs, wall, counts, before, eng.stats()


def path_top2_gaps(torch, model, prompt, toks):
    """The target's top-2 logit gap at each token of one greedy path: a
    dense f32-cache forward of the prompt and the tokens, row ``j`` the
    logits that chose token ``j``."""
    seq = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
    ids = torch.from_numpy(seq)[None].to(model.word_embed.weight.data()
                                         .device)
    ck, cv = model.init_cache(1, len(seq), dtype="float32")
    with torch.no_grad():
        lg = model.decode_step(ids, ck, cv, 0)[0][0, len(prompt) - 1:]
    top = torch.topk(lg, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def spec_replay_equals_eager(torch, target, draft, wrappers):
    """One replay of each of the draft, verify and suffix-prefill
    programs against one eager call on the same inputs: bitwise equal
    outputs, pools and launches, the launches as each program's layers
    imply (draft: K+1 steps of 1 layer; verify and suffix: L layers).
    Returns the results and the verify lanes' state for the timings."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        paged_spec_draft_program, paged_spec_verify_program,
        paged_suffix_prefill_program)

    dev = target.word_embed.weight.data().device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 12)
    # each lane's blocks cover every position verify writes (pos + K):
    # lanes writing into the shared trash block would race on its slots
    lengths = [p_ + SPEC_K + 1 for p_ in spec_lane_positions()]
    toks, pk, pv, table, pos = decode_state(torch, target, lengths, gen)
    prev, dk, dv, _, _ = decode_state(torch, draft, lengths, gen)
    pos -= SPEC_K
    dprog = paged_spec_draft_program(draft, draft_k=SPEC_K)
    vprog = paged_spec_verify_program(target, draft_k=SPEC_K)
    d_toks, d_lgs = (t.clone() for t in dprog.eager(
        prev, toks, dk.clone(), dv.clone(), table, pos, gen)[:2])
    sb, tail = 32, SPEC_CONFIGS[2][0]
    sprog = paged_suffix_prefill_program(target, suffix_len=sb,
                                         block_size=SPEC_BS)
    suffix = torch.zeros((1, sb), dtype=torch.int32, device=dev)
    suffix[0, :tail] = torch.randint(0, CFG["vocab_size"], (tail,),
                                     generator=gen, device=dev)
    layers = CFG["num_layers"]

    def per_program(n_layers, forwards):
        return dict({k: 0 for k in wrappers},
                    layer_norm_fwd=(2 * n_layers + 1) * forwards,
                    paged_attention=n_layers * forwards,
                    qkv_project=n_layers * forwards,
                    out_project=n_layers * forwards)

    out = replays_equal_eager(torch, wrappers, (
        ("draft", dprog, (dk, dv), per_program(1, SPEC_K + 1),
         lambda call, k_, v_: call(prev, toks, k_, v_, table, pos, gen)),
        ("verify", vprog, (pk, pv), per_program(layers, 1),
         lambda call, k_, v_: call(toks, d_toks, d_lgs, k_, v_, table, pos,
                                   gen)),
        (f"suffix bucket {sb}", sprog, (pk, pv), per_program(layers, 1),
         lambda call, k_, v_: call(suffix, SPEC_PREFIX, tail - 1, k_, v_,
                                   table[:1], gen))))
    state = {"draft": (dprog, prev, toks, dk, dv, table, pos, gen),
             "verify": (vprog, pk, pv)}
    return out, state


def spec_round_times(torch, card, state, profile):
    """Device and host ms of one speculative round (the draft program,
    then verify on its outputs), replayed and eager, on the verify
    lanes' state with every input on the card."""
    dprog, prev, toks, dk, dv, table, pos, gen = state["draft"]
    vprog, pk, pv = state["verify"]

    def round_(draft_call, verify_call):
        d_toks, d_lgs, _, _ = draft_call(prev, toks, dk, dv, table, pos, gen)
        return verify_call(toks, d_toks, d_lgs, pk, pv, table, pos, gen)

    out = {}
    for mode, calls in (("replayed", (dprog, vprog)),
                        ("eager", (dprog.eager, vprog.eager))):
        dev_ms, host_ms = time_ms(lambda i: round_(*calls), iters=10,
                                  warmup=2)
        out[mode] = {"device_ms": dev_ms, "host_ms": host_ms,
                     "device_busy": dev_ms / host_ms}
        print(f"spec round on {card} ({SPEC_LANES} lanes, K {SPEC_K}), "
              f"{mode}: device_ms {dev_ms:.4f} host_ms {host_ms:.4f} "
              f"(device busy {dev_ms / host_ms:.3f})", flush=True)
    if profile:
        out["profiler_device_ms"] = profile_decode(
            torch, lambda *a: round_(dprog, vprog), (), None,
            "spec_profile.txt")
    return out


def prefill_vs_suffix_times(torch, target, card, state):
    """The target's suffix prefill (buckets 16 and 32, after the 448
    cached tokens) against the full prefill (bucket 512) of the same
    prompt lengths, replayed, int8 pools, inputs on the card."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        paged_prefill_program, paged_suffix_prefill_program)

    _, _, _, _, _, table, _, gen = state["draft"]
    _, pk, pv = state["verify"]
    dev = pk.device
    full = SPEC_BS * (1 << (-(-SPEC_MAX_CONTEXT // SPEC_BS) - 1).bit_length())
    nb = full // SPEC_BS
    fprog = paged_prefill_program(target, prefill_len=full,
                                  block_size=SPEC_BS, kv_cache_dtype="int8")
    fk, fv = target.init_block_pool(nb + 1, SPEC_BS, dtype="int8")
    ids = torch.arange(nb, dtype=torch.int64, device=dev)
    out = {}
    for tail in (4, 20):
        sb = 16 if tail <= 16 else 32
        p = SPEC_PREFIX + tail
        sprog = paged_suffix_prefill_program(target, suffix_len=sb,
                                             block_size=SPEC_BS)
        suffix = torch.randint(0, CFG["vocab_size"], (1, sb), generator=gen,
                               device=dev, dtype=torch.int32)
        prompt = torch.randint(0, CFG["vocab_size"], (1, full), generator=gen,
                               device=dev, dtype=torch.int32)
        start = torch.tensor([SPEC_PREFIX], dtype=torch.int64, device=dev)
        s_last = torch.tensor([tail - 1], dtype=torch.int64, device=dev)
        f_last = torch.tensor([p - 1], dtype=torch.int64, device=dev)
        s_ms = time_ms(lambda i: sprog(suffix, start, s_last, pk, pv,
                                       table[:1], gen), iters=10, warmup=2)
        f_ms = time_ms(lambda i: fprog(prompt, f_last, fk, fv, ids, gen),
                       iters=10, warmup=2)
        out[p] = {"suffix_bucket": sb, "suffix_device_ms": s_ms[0],
                  "suffix_host_ms": s_ms[1], "full_bucket": full,
                  "full_device_ms": f_ms[0], "full_host_ms": f_ms[1]}
        print(f"prompt {p} on {card}, replayed: suffix prefill (bucket {sb} "
              f"after {SPEC_PREFIX} cached) device_ms {s_ms[0]:.4f} host_ms "
              f"{s_ms[1]:.4f}; full prefill (bucket {full}) device_ms "
              f"{f_ms[0]:.4f} host_ms {f_ms[1]:.4f} ({f_ms[0] / s_ms[0]:.1f}x)",
              flush=True)
    return out


def spec_sampling_check(torch, target, draft, prompt):
    """A sampling spec engine (top-k 50, temperature 0.8) replays draft
    and verify graphs that draw from its generator: two requests for the
    same prompt give tokens in the vocabulary that differ, and the
    generator's offset moved."""
    from mxnet_tpu_torch.serving.llm import LLMEngine

    with LLMEngine(target, draft_model=draft, draft_k=SPEC_K, greedy=False,
                   temperature=0.8, top_k=50, seed=3, prefix_cache=True,
                   max_running=4, block_size=SPEC_BS,
                   max_context=SPEC_MAX_CONTEXT) as eng:
        eng.warmup([len(prompt)])
        state = eng._gen.get_state().clone()
        outs = [eng.generate(prompt, 16) for _ in range(2)]
        moved = not torch.equal(state, eng._gen.get_state())
        st = eng.stats()
    ok = all(((o >= 0) & (o < CFG["vocab_size"])).all() for o in outs)
    print(f"sampling spec engine (top-k 50, temperature 0.8) replaying "
          f"graphs: {outs[0].tolist()} then {outs[1].tolist()}; generator "
          f"moved {moved}; graphs {st['graphs']}; {st['speculative']}",
          flush=True)
    check(ok and moved and not np.array_equal(outs[0], outs[1])
          and st["graphs"]["replays"] > 0,
          "sampling through the spec graphs does not draw anew")
    return {"tokens": [o.tolist() for o in outs], "generator_moved": moved,
            "graphs": st["graphs"], "speculative": st["speculative"]}


def spec_prefix_phase(torch, card, wrappers, profile):
    """Phase 10: the spec+prefix engine against the plain engine on the
    same target and workload (SPEC_* above): greedy tokens identical,
    exact launch counts of the timed run, the prefix hit rate and the
    cache's blocks; an f32-KV spec+prefix engine against the dense
    ``generate``; each new program's replay against an eager call; a
    sampling spec engine; and the times."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import generate
    from mxnet_tpu_torch.serving.llm import LLMEngine

    t_phase = time.perf_counter()
    target, draft = spec_models(torch)
    rng = np.random.default_rng(SEED + 10)
    shared = rng.integers(0, CFG["vocab_size"], SPEC_PREFIX).astype(np.int32)
    reqs = spec_workload(rng, shared, SPEC_REQUESTS)
    prime = spec_workload(np.random.default_rng(SEED + 11), shared,
                          SPEC_PRIME)
    total = sum(n for _, n in reqs)
    kw = dict(max_running=SPEC_LANES, block_size=SPEC_BS,
              max_context=SPEC_MAX_CONTEXT)
    layers, kk = CFG["num_layers"], SPEC_K
    out = {"config": {"lanes": SPEC_LANES, "draft_k": kk, "block_size":
                      SPEC_BS, "prefix": SPEC_PREFIX, "configs": SPEC_CONFIGS,
                      "requests": SPEC_REQUESTS, "alpha": SPEC_ALPHA,
                      "max_context": SPEC_MAX_CONTEXT, "card": card}}

    def delta(before, after, section, key):
        return after[section][key] - before[section][key]

    engines = {}
    for name, extra, primed in (
            ("plain", {}, prime[:len(SPEC_CONFIGS)]),
            ("spec_prefix", dict(draft_model=draft, draft_k=kk,
                                 prefix_cache=True), prime)):
        with LLMEngine(target, **kw, **extra) as eng:
            toks, wall, counts, before, after = spec_serve(
                torch, eng, reqs, primed, wrappers)
            evictable = eng.evictable_blocks()
        steps = delta(before, after, "counters", "decode_steps")
        prefills = delta(before, after, "counters", "prefills")
        row = {"tok_s": total / wall, "wall_s": wall, "decode_steps": steps,
               "prefills": prefills, "launches": counts,
               "prefill_ms": 1e3 * (after["prefill_s"] - before["prefill_s"])
               / prefills, "round_ms": 1e3 * (after["decode_s"]
                                              - before["decode_s"]) / steps,
               "graphs": after["graphs"]}
        if name == "plain":
            expected = dict({k: 0 for k in wrappers},
                            layer_norm_fwd=(2 * layers + 1)
                            * (prefills + steps),
                            paged_attention=layers * steps,
                            qkv_project=layers * steps,
                            out_project=layers * steps)
            formula = (f"{prefills} full prefills x (2L+1) K2 + {steps} "
                       f"decode steps x (L of K4, K5a, K5b and 2L+1 K2)")
        else:
            rounds = delta(before, after, "counters", "spec_steps")
            suffix = delta(before, after, "prefix_cache", "hit_requests")
            full = prefills - suffix
            hit = delta(before, after, "prefix_cache", "hit_tokens")
            miss = delta(before, after, "prefix_cache", "miss_tokens")
            proposed = delta(before, after, "speculative", "proposed")
            accepted = delta(before, after, "speculative", "accepted")
            per = layers * (rounds + suffix) + (kk + 1) * rounds + suffix
            expected = dict(
                {k: 0 for k in wrappers},
                layer_norm_fwd=(2 * layers + 1) * (rounds + suffix + full)
                + 3 * (kk + 1) * rounds + 3 * (suffix + full),
                paged_attention=per, qkv_project=per, out_project=per)
            formula = (f"{rounds} rounds x (verify: L of K4, K5a, K5b, 2L+1 "
                       f"K2; draft: K+1 of each, 3(K+1) K2) + {suffix} suffix "
                       f"prefills x (L of each, 2L+1 K2; the draft's 1, 1, 1, "
                       f"3) + {full} full prefills x (2L+1 K2; the draft's 3)")
            twenties = sum(1 for p, _ in prime + reqs
                           if len(p) // SPEC_BS > SPEC_PREFIX // SPEC_BS)
            pc = after["prefix_cache"]
            row.update(spec_rounds=rounds, suffix_prefills=suffix,
                       full_prefills=full, hit_tokens=hit, miss_tokens=miss,
                       prefix_hit_rate=hit / (hit + miss),
                       proposed=proposed, accepted=accepted,
                       acceptance_rate=accepted / proposed,
                       cached_blocks=pc["cached_blocks"],
                       tokens_per_round=total / rounds)
            print(f"spec+prefix engine: acceptance {accepted}/{proposed} = "
                  f"{accepted / proposed:.4f}, prefix hit rate {hit}/"
                  f"{hit + miss} = {hit / (hit + miss):.4f}, {suffix} suffix "
                  f"and {full} full prefills, cached blocks "
                  f"{pc['cached_blocks']} (expected {SPEC_PREFIX // SPEC_BS} "
                  f"+ {twenties}), free {after['pool_blocks_free']} of "
                  f"{after['pool_blocks_total']}, evictable {evictable}",
                  flush=True)
            check(hit / (hit + miss) > 0.9 and full == 0,
                  f"prefix hit rate {hit}/{hit + miss}, {full} full prefills")
            check(pc["cached_blocks"] == SPEC_PREFIX // SPEC_BS + twenties,
                  f"cached blocks {pc['cached_blocks']}")
            check(after["pool_blocks_free"] + pc["cached_blocks"]
                  == after["pool_blocks_total"]
                  and evictable == pc["cached_blocks"],
                  "after the run a block is held by more than the cache")
        print(f"{name} engine on {card}: {SPEC_REQUESTS} requests, {total} "
              f"new tokens in {wall:.3f} s = {total / wall:.1f} tok/s; "
              f"{steps} decode steps or rounds ({row['round_ms']:.3f} host ms "
              f"each), {prefills} prefills ({row['prefill_ms']:.3f} ms each); "
              f"launches {counts}, expected {expected}: {formula}",
              flush=True)
        check(counts == expected, f"{name}: launch counts {counts} != "
              f"{expected}")
        check(after["graphs"]["captures"] == before["graphs"]["captures"],
              f"{name}: the timed run captured a graph")
        engines[name] = toks
        out[name] = row
    gaps = {name: [path_top2_gaps(torch, target, p, t)
                   for (p, _), t in zip(reqs, toks)]
            for name, toks in engines.items()}
    least = min((float(g.min()), name, i, int(g.argmin()))
                for name, per in gaps.items() for i, g in enumerate(per))
    out["top2_gap"] = {"min": least[0], "engine": least[1],
                       "request": least[2], "token": least[3]}
    print(f"smallest top-2 logit gap of the target along both engines' "
          f"greedy paths ({sum(len(g) for g in gaps['plain'])} tokens each; "
          f"dense f32-KV forwards): {least[0]:.4e} ({least[1]} engine, "
          f"request {least[2]}, token {least[3]})", flush=True)
    for i, (a_, b_) in enumerate(zip(engines["spec_prefix"],
                                     engines["plain"])):
        if not np.array_equal(a_, b_):
            j = int(np.nonzero(a_[:len(b_)] != b_[:len(a_)])[0][0])
            print(f"request {i}: spec+prefix token {j} is {a_[j]}, plain "
                  f"{b_[j]}; the target's top-2 logit gap there (dense, f32 "
                  f"KV) {gaps['plain'][i][j]:.3e}", flush=True)
            check(False, f"request {i}: greedy tokens differ at {j}")
    print(f"spec+prefix engine == plain engine: greedy tokens identical on "
          f"{SPEC_REQUESTS} requests ({total} tokens); tok/s "
          f"{out['spec_prefix']['tok_s']:.1f} against "
          f"{out['plain']['tok_s']:.1f} "
          f"({out['spec_prefix']['tok_s'] / out['plain']['tok_s']:.2f}x)",
          flush=True)

    with LLMEngine(target, kv_cache_dtype="float32", draft_model=draft,
                   draft_k=kk, prefix_cache=True, **kw) as eng:
        paged = [eng.generate(p, n) for p, n in reqs[:3]]
        hits = eng.stats()["prefix_cache"]["hit_requests"]
    for (p, n), got in zip(reqs[:3], paged):
        want = generate(target, p[None], n).cpu().numpy()[0]
        check(np.array_equal(got, want), f"f32 spec+prefix engine "
              f"{got.tolist()} != dense generate {want.tolist()}")
    check(hits == 2, f"f32 engine: {hits} prefix hits")
    print("spec+prefix engine (f32 KV) == dense generate: greedy tokens "
          "identical on 3 requests (a full prefill, then 2 suffix prefills)",
          flush=True)
    out["replay_vs_eager"], state = spec_replay_equals_eager(
        torch, target, draft, wrappers)
    out["sampling"] = spec_sampling_check(torch, target, draft, reqs[0][0])
    out["round"] = spec_round_times(torch, card, state, profile)
    out["prefill_vs_suffix"] = prefill_vs_suffix_times(torch, target, card,
                                                       state)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10 took {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 11: the training front door ----------------------------------------
# example/gluon/image_classification.py:113-131's loop on phase 9's
# ResNet-50 (B 32, 224x224, seed 0, default policy): NAG (lr 0.05,
# momentum 0.9, wd 1e-4) under MultiFactorScheduler(step=[3, 5], factor
# 0.1, warmup_steps=2), SoftmaxCrossEntropyLoss and a composite of
# Accuracy, TopKAccuracy(5) and Loss, for FRONT_STEPS steps; the states
# round trip after step 3; the same net in bfloat16 with
# SGD(multi_precision=True); phase 7's gpt_like with LAMB under
# CosineScheduler(max_update=3, warmup_steps=1) and Perplexity; and one
# update of every registered optimizer at gpt_like's embedding width
FRONT_STEPS, FRONT_MP_STEPS, FRONT_LM_STEPS = 6, 3, 3
FRONT_SCHEDULE = dict(step=[3, 5], factor=0.1, warmup_steps=2)
FRONT_NAG = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
FRONT_LAMB = {"learning_rate": 0.01, "wd": 0.01}
# One update on the card against the same update of the port on the
# CPU, as max|card - cpu| over the tensor's largest magnitude, for the
# weights and every state tensor: the elementwise chains are the same
# float32 operations on both, each rounded once, though a library's
# sqrt, division or power may land an ulp apart (up to 4.6e-7 of the
# magnitude measured on one H100); LARS and LAMB sum their norms in
# float64 on both. 1e-5 leaves 20x.
FRONT_OPT_TOL = 1e-5
# every registered optimizer with its defaults, and the variants of the
# CPU tests (Adam without bias correction, centered RMSProp)
FRONT_OPTIMIZERS = [
    ("sgd", {"momentum": 0.9}), ("nag", {}), ("signum", {}), ("sgld", {}),
    ("dcasgd", {"momentum": 0.9}), ("lars", {}), ("adam", {}),
    ("adam", {"correct_bias": False}), ("adamw", {}), ("adamax", {}),
    ("nadam", {}), ("adagrad", {}), ("adadelta", {}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 0.5}), ("ftrl", {}),
    ("ftml", {}), ("lamb", {}), ("groupadagrad", {})]


def front_resnet_lr(u):
    """The rate of MultiFactorScheduler(**FRONT_SCHEDULE) at update ``u``
    inside an optimizer with learning_rate 0.05, in closed form: a linear
    warmup from 0 to the scheduler's own base_lr (0.01, which the
    optimizer's learning_rate does not replace), then 0.05 times 0.1 for
    each step passed."""
    if u < FRONT_SCHEDULE["warmup_steps"]:
        return 0.01 * u / FRONT_SCHEDULE["warmup_steps"]
    return 0.05 * FRONT_SCHEDULE["factor"] ** sum(
        u > s for s in FRONT_SCHEDULE["step"])


def front_lm_lr(u):
    """CosineScheduler(max_update=3, warmup_steps=1)'s rate at ``u``: half
    a cosine from its own base_lr (0.01) to 0 over updates 1..3."""
    if u < 1:
        return 0.0
    return 0.01 * (1 + math.cos(math.pi * (u - 1) / 2)) / 2


def close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def states_equal(torch, a, b):
    """Two state trees (tuples of tensors) equal bitwise."""
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(states_equal(torch, x, y) for x, y in zip(a, b)))
    return a.dtype == b.dtype and torch.equal(a, b)


def event_span(torch, fn):
    """Run ``fn()`` (a Trainer's update) between two CUDA events and return
    their elapsed ms: the card's time from the end of the work enqueued
    before ``fn`` to the end of ``fn``'s, its idle waits for the launches
    included, so the share of the step the update adds."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def front_resnet(torch, card, wrappers):
    """Phase 11's ResNet-50 loop (FRONT_* above) under the default policy:
    each step's rate equals :func:`front_resnet_lr`, K3 launches once a
    step and no other kernel of the port, the loss falls, and the
    metrics equal the counts taken on the host. After step 3 the states
    go through a .states file into a fresh Trainer (bitwise equal), and
    from step 4's gradients both Trainers' updates give bitwise-equal
    weights. Then ``net.cast("bfloat16")`` and FRONT_MP_STEPS steps of
    SGD(multi_precision=True): every master float32 and every weight its
    master rounded to bfloat16 bitwise, K3 in bfloat16, the loss falling.
    """
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon import Trainer, metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.optimizer.lr_scheduler import MultiFactorScheduler

    dev = mx.context.resolve_device(None)
    net = vision.get_model("resnet50_v1", classes=RN_CLASSES)
    net.initialize()
    rng = np.random.default_rng(SEED + 9)
    x = torch.from_numpy(rng.random((RN_B, 3, RN_HW, RN_HW),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, RN_CLASSES, RN_B)).to(dev)
    with autograd.pause():
        net(x[:1])
    from_jax_params(resnet_weights(net, SEED), net)
    params = net.collect_params()
    live = [p.data() for p in params.values() if p.grad_req != "null"]
    loss_fn = SoftmaxCrossEntropyLoss()

    def trainer_nag():
        return Trainer(params, "nag", dict(
            FRONT_NAG, lr_scheduler=MultiFactorScheduler(**FRONT_SCHEDULE)))

    trainer = trainer_nag()
    comp = metric.CompositeEvalMetric([metric.Accuracy(),
                                       metric.TopKAccuracy(5),
                                       metric.Loss()])
    host = {"correct": 0, "top5": 0, "n": 0, "loss_sum": 0.0, "loss_n": 0}
    losses, rates, host_ms, update_ms, metric_ms = [], [], [], [], []
    out = {"card": card, "batch": RN_B, "policy": "default"}
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mxnet_tpu_torch", "_build", "chip_smoke_states")
    for w in wrappers.values():
        w.launches = 0
    with matmul_precision_scope("default"):
        for k in range(1, FRONT_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                logits = net(x)
                loss = loss_fn(logits, y)
            autograd.backward(loss)
            if k == 4:        # the round trip takes this step's update
                out["states_round_trip"] = front_states_round_trip(
                    torch, live, trainer, trainer_nag, tmp)
            else:
                upd = event_span(torch, lambda: trainer.step(RN_B))
            torch.cuda.synchronize()
            if k not in (1, 4):
                host_ms.append(1e3 * (time.perf_counter() - t0))
                update_ms.append(upd)
            rates.append(trainer.learning_rate)
            check(close(rates[-1], front_resnet_lr(k)),
                  f"step {k}: lr {rates[-1]} != {front_resnet_lr(k)}")
            logits, loss = logits.detach(), loss.detach()
            t0 = time.perf_counter()
            comp.metrics[0].update([y], [logits])
            comp.metrics[1].update([y], [logits])
            comp.metrics[2].update(None, [loss])
            metric_ms.append(1e3 * (time.perf_counter() - t0))
            lg, lab = logits.cpu().numpy(), y.cpu().numpy()
            ls = loss.cpu().numpy().astype(np.float64)
            host["correct"] += int((lg.argmax(-1) == lab).sum())
            top5 = np.argsort(-lg, axis=-1, kind="stable")[:, :5]
            host["top5"] += int((top5 == lab[:, None]).any(-1).sum())
            host["n"] += RN_B
            host["loss_sum"] += float(ls.sum())
            host["loss_n"] += ls.size
            losses.append(float(ls.mean()))
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers}, cross_entropy_lse=FRONT_STEPS)
    check(counts == want, f"front ResNet launches {counts} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"front ResNet loss did not fall: {losses}")
    names, values = comp.get()
    want_vals = [host["correct"] / host["n"], host["top5"] / host["n"],
                 host["loss_sum"] / host["loss_n"]]
    check(values[0] == want_vals[0] and values[1] == want_vals[1]
          and close(values[2], want_vals[2], 1e-9),
          f"metrics {dict(zip(names, values))} != host {want_vals}")
    step_ms = float(np.mean(host_ms))
    out.update(losses=losses, rates=rates, host_ms=host_ms, step_ms=step_ms,
               img_s=RN_B / step_ms * 1e3, update_ms=update_ms,
               metric_ms=metric_ms,
               metrics=dict(zip(names, values)), launches=counts)
    print(f"front door, resnet50_v1 on {card}, default policy: NAG lr 0.05 "
          f"momentum 0.9 wd 1e-4, MultiFactorScheduler {FRONT_SCHEDULE}; "
          f"rates {rates} (closed form); loss {[round(v, 5) for v in losses]};"
          f" step ms (host wall to a synchronise; steps 2, 3, 5 and 6: "
          f"step 1 holds cuDNN's first-call set-up, step 4 the round trip) "
          f"{[round(v, 3) for v in host_ms]}, {out['img_s']:.1f} "
          f"img/s, of which Trainer.step (CUDA events around it) "
          f"{[round(v, 3) for v in update_ms]} ms; metrics {dict(zip(names, values))} equal the host's "
          f"counts, three updates {[round(v, 3) for v in metric_ms]} ms "
          f"(one transfer each); launches {counts}", flush=True)

    # multi_precision in bfloat16 ----------------------------------------
    net.cast("bfloat16")
    xb = x.bfloat16()
    mp = Trainer(params, "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                                 "multi_precision": True})
    mp_losses, mp_ms, mp_update_ms = [], [], []
    for w in wrappers.values():
        w.launches = 0
    with matmul_precision_scope("default"):
        for _ in range(FRONT_MP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                logits = net(xb)
                loss = loss_fn(logits, y)
            autograd.backward(loss)
            mp_update_ms.append(event_span(torch, lambda: mp.step(RN_B)))
            torch.cuda.synchronize()
            mp_ms.append(1e3 * (time.perf_counter() - t0))
            check(logits.dtype == torch.bfloat16,
                  f"bfloat16 net gave {logits.dtype} logits")
            mp_losses.append(loss.float().mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers}, cross_entropy_lse=FRONT_MP_STEPS)
    check(counts == want, f"bfloat16 launches {counts} != {want}")
    check(all(np.isfinite(mp_losses)) and mp_losses[-1] < mp_losses[0],
          f"bfloat16 loss did not fall: {mp_losses}")
    n_master = 0
    live_idx = [i for i, p in enumerate(params.values())
                if p.grad_req != "null"]
    for i, w in zip(live_idx, live):
        master, inner = mp._states[i]
        check(w.dtype == torch.bfloat16 and master.dtype == torch.float32
              and isinstance(inner, tuple)
              and inner[0].dtype == torch.float32,
              f"parameter {i}: weight {w.dtype}, master {master.dtype}")
        check(torch.equal(w.detach(), master.bfloat16()),
              f"parameter {i}: weight is not its master rounded")
        check(master.data_ptr() != w.data_ptr(),
              f"parameter {i}: the master shares the weight's storage")
        n_master += 1
    out["multi_precision"] = {"losses": mp_losses, "host_ms": mp_ms,
                              "update_ms": mp_update_ms,
                              "masters": n_master, "launches": counts}
    print(f"front door, resnet50_v1 bfloat16 with SGD(multi_precision=True)"
          f" lr 0.05 momentum 0.9: loss {[round(v, 5) for v in mp_losses]}, "
          f"step ms {[round(v, 3) for v in mp_ms]} (Trainer.step "
          f"{[round(v, 3) for v in mp_update_ms]}); all {n_master} masters "
          f"float32 and every weight its master rounded to bfloat16 "
          f"bitwise; K3 in bfloat16, launches {counts}", flush=True)
    return out


def front_states_round_trip(torch, live, trainer, make, tmp):
    """After step 3: ``save_states`` and ``load_states`` into a fresh
    Trainer (``make()``) give bitwise-equal states and counts; from the
    gradients the caller's backward left, the fresh Trainer's update and
    then (weights and gradients restored) ``trainer``'s, which is step 4,
    give bitwise-equal weights."""
    import shutil

    os.makedirs(tmp, exist_ok=True)
    fname = os.path.join(tmp, "resnet50.states")
    try:
        trainer.save_states(fname)
        size = os.path.getsize(fname)
        fresh = make()
        fresh.load_states(fname)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a, b = trainer.optimizer, fresh.optimizer
    check(a.num_update == b.num_update == 3
          and a._index_update_count == b._index_update_count,
          f"counts: {a.num_update} {b.num_update}")
    check(sorted(trainer._states) == sorted(fresh._states)
          and all(states_equal(torch, trainer._states[i], fresh._states[i])
                  for i in trainer._states),
          "states after load_states differ")
    weights = [w.detach().clone() for w in live]
    grads = [w.grad.clone() for w in live]
    fresh.step(RN_B)
    after = [w.detach().clone() for w in live]
    with torch.no_grad():
        for w, w0, g in zip(live, weights, grads):
            w.copy_(w0)
            w.grad = g
    trainer.step(RN_B)
    check(all(torch.equal(w, f) for w, f in zip(live, after)),
          "the two Trainers' updates differ")
    print(f".states round trip after step 3: {size} bytes, "
          f"{len(trainer._states)} states bitwise equal in a fresh "
          f"Trainer; both Trainers' updates from one set of gradients "
          f"bitwise equal", flush=True)
    return {"bytes": size, "states": len(trainer._states)}


def front_lm(torch, card, wrappers):
    """Phase 11's gpt_like: phase 7's model and batch (B 8, L 1024, seeded
    weights and tokens) under the default policy, FRONT_LM_STEPS steps of
    ``Trainer(model.collect_params(), "lamb")`` under
    CosineScheduler(max_update=3, warmup_steps=1), and the Perplexity
    metric on the softmax of each step's logits: each step's rate equals
    :func:`front_lm_lr`, the launches of K1 forward, K1c, K1d, K2 and K3
    per step are exactly phase 7's, the loss falls, and the perplexity is
    exp of the mean token loss (1e-5)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon import Trainer, metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like
    from mxnet_tpu_torch.optimizer.lr_scheduler import CosineScheduler

    model = gpt_like(**CFG)
    from_jax_params(seeded_params(model, SEED), model)
    dev = model.word_embed.weight.data().device
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    tokens = torch.randint(0, CFG["vocab_size"], (TRAIN_B, TRAIN_L),
                           generator=gen, device=dev)
    trainer = Trainer(model.collect_params(), "lamb", dict(
        FRONT_LAMB, lr_scheduler=CosineScheduler(max_update=3,
                                                 warmup_steps=1)))
    loss_fn = SoftmaxCrossEntropyLoss()
    ppl = metric.Perplexity()
    losses, rates, host_ms, update_ms = [], [], [], []
    for w in wrappers.values():
        w.launches = 0
    with matmul_precision_scope("default"):
        for k in range(1, FRONT_LM_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with autograd.record():
                logits = model(tokens)[:, :-1]
                loss = loss_fn(logits, tokens[:, 1:])
            autograd.backward(loss)
            update_ms.append(event_span(torch, lambda: trainer.step(TRAIN_B)))
            torch.cuda.synchronize()
            host_ms.append(1e3 * (time.perf_counter() - t0))
            rates.append(trainer.learning_rate)
            check(close(rates[-1], front_lm_lr(k)),
                  f"step {k}: lr {rates[-1]} != {front_lm_lr(k)}")
            with torch.no_grad():
                probs = torch.softmax(logits.detach(), dim=-1)
            ppl.update([tokens[:, 1:]], [probs.reshape(-1, CFG["vocab_size"])])
            del probs, logits
            losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = {k: FRONT_LM_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    check(counts == want, f"front gpt_like launches {counts} != {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"front gpt_like loss did not fall: {losses}")
    name, value = ppl.get()
    want_ppl = math.exp(float(np.mean(losses)))
    check(close(value, want_ppl, 1e-5),
          f"perplexity {value} != exp(mean loss) {want_ppl}")
    print(f"front door, gpt_like {CFG} B{TRAIN_B} L{TRAIN_L} on {card}, "
          f"default policy: LAMB {FRONT_LAMB} under CosineScheduler("
          f"max_update=3, warmup_steps=1); rates {rates} (closed form); "
          f"loss {[round(v, 5) for v in losses]}; {name} {value:.4f} = "
          f"exp(mean loss) {want_ppl:.4f}; step ms "
          f"{[round(v, 3) for v in host_ms]} (Trainer.step, CUDA events "
          f"around it: {[round(v, 3) for v in update_ms]}); launches "
          f"{counts} (phase 7's per step)", flush=True)
    return {"losses": losses, "rates": rates, "host_ms": host_ms,
            "update_ms": update_ms, "perplexity": value, "launches": counts}


def front_optimizers(torch, card):
    """Phase 11's optimizer zoo: each of FRONT_OPTIMIZERS takes one update
    (wd 1e-2 but GroupAdaGrad's 0, clip_gradient 1.0) of gpt_like's
    (32000, 768) embedding and a (768,) bias (GroupAdaGrad: the
    embedding alone; it takes no 1-D weight) from seeded weights and
    gradients, on the card and in the port on the CPU (SGLD given the
    same noise on both): weights and states within FRONT_OPT_TOL of the
    largest magnitude. Then the card's update is timed (device ms, the
    tensors' chains of elementwise launches; for the record)."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.context import resolve_device

    rng = np.random.default_rng(SEED + 11)
    shapes = [(CFG["vocab_size"], CFG["units"]), (CFG["units"],)]
    weights = [rng.standard_normal(s, dtype=np.float32) * np.float32(0.02)
               for s in shapes]
    grads = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    noise = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    dev = resolve_device(None)
    rows = []
    for name, kw in FRONT_OPTIMIZERS:
        n = 1 if name == "groupadagrad" else 2
        label = name + "".join(f" {k}={v}" for k, v in kw.items())
        kw = dict(kw, clip_gradient=1.0,
                  wd=0.0 if name == "groupadagrad" else 1e-2)
        runs = {}
        for where in ("cpu", dev):
            opt = opt_mod.create(name, **kw)
            ws = [torch.from_numpy(w).to(where, copy=True)
                  for w in weights[:n]]
            gs = [torch.from_numpy(g).to(where) for g in grads[:n]]
            states = [opt.create_state_multi_precision(i, w)
                      for i, w in enumerate(ws)]
            if name == "sgld":
                fed = iter([torch.from_numpy(z).to(where)
                            for z in noise[:n]])
                opt.draw_noise = lambda w, fed=fed: next(fed)
            opt.update(list(range(n)), ws, gs, states)
            runs[where] = (opt, ws, gs, states)
        err = 0.0
        for a, b in zip(runs[dev][1] + [t for s in runs[dev][3] for t in s],
                        runs["cpu"][1] + [t for s in runs["cpu"][3]
                                          for t in s]):
            scale = max(b.abs().max().item(), 1e-30)
            err = max(err, (a.cpu() - b).abs().max().item() / scale)
        check(err <= FRONT_OPT_TOL, f"{name} {kw}: card vs CPU {err}")
        opt, ws, gs, states = runs[dev]
        if name == "sgld":
            del opt.draw_noise           # the generator's draws again
        ms = time_ms(lambda i: opt.update(list(range(n)), ws, gs, states),
                     iters=20, warmup=2)[0]
        rows.append({"name": name, "label": label, "err": err, "ms": ms,
                     "tensors": n})
    print(f"front door, every registered optimizer on {card}: one update of "
          f"the (32000, 768) embedding and a (768,) bias against the port on "
          f"the CPU (limit {FRONT_OPT_TOL:g} of the largest magnitude), "
          f"device ms per update (for the record): "
          + "; ".join(f"{r['label']} err {r['err']:.2e} {r['ms']:.4f} ms"
                      for r in rows),
          flush=True)
    names = {r["name"] for r in rows}
    check(names == set(opt_mod.optimizer._registry),
          f"optimizers not run on the card: "
          f"{set(opt_mod.optimizer._registry) - names}")
    return rows


def front_phase(torch, card, wrappers):
    """Phase 11: the training front door on the card (:func:`front_resnet`,
    :func:`front_lm`, :func:`front_optimizers`)."""
    t_phase = time.perf_counter()
    out = {"resnet": front_resnet(torch, card, wrappers)}
    torch.cuda.empty_cache()
    out["gpt_like"] = front_lm(torch, card, wrappers)
    torch.cuda.empty_cache()
    out["optimizers"] = front_optimizers(torch, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11 took {out['seconds']:.1f} s: launches of the port's "
          f"kernels K3 (ResNet-50, f32 and bfloat16) and K1 forward, K1c, "
          f"K1d, K2, K3 (gpt_like); the optimizers, schedulers and metrics "
          f"are torch's elementwise and reduction kernels", flush=True)
    return out


# -- phase 12: BERT-base pretraining and the rest of the model zoo -----------
# benchmark/train_bench.py:51-60, 72, 88-91 and 792: BERTForPretraining(
# bert_base(dropout=0.0)) (vocab 30522, units 768, hidden 3072, 12 layers,
# 12 heads), ``initialize()``'s Uniform(0.07), batch 32 of 128 seeded
# tokens, SGD with momentum 0.9 and lr 0.05 on the MLM loss over every
# position with the tokens as labels; the forward computes the NSP
# logits too, and the bench leaves them out of its loss. With the NSP
# loss added at lr 0.05 its head diverges (:func:`bert_nsp_probe` prints
# both losses of such steps: the update of a 2-way Dense over 768 tanh
# features overshoots), so the NSP loss on seeded labels enters the step
# whose gradients are checked. Each sequence is a pair: token type 0 on
# its first half, 1 on the second
BERT_B, BERT_L, BERT_VOCAB, BERT_STEPS = 32, 128, 30522, 3
# a step with both losses: K1 forward, K1c and K1d once per layer; K2 for
# embed_ln, each layer's ln1 and ln2, and mlm_ln; K3 for the MLM and the
# NSP losses. The bench's step: K3 for the MLM loss alone
BERT_LAUNCHES = dict({k: 0 for k in TRAIN_LAUNCHES},
                     flash_attention_fwd=12, flash_attention_bwd_dq=12,
                     flash_attention_bwd_dkv=12, layer_norm_fwd=26,
                     cross_entropy_lse=2)
BERT_TRAIN_LAUNCHES = dict(BERT_LAUNCHES, cross_entropy_lse=1)
# the port's kernels in a profiled step, by name
BERT_KINDS = {"K1": r"flash_(fwd|bwd)", "K2": r"ln_fwd", "K3": r"row_lse"}
BERT_LARGE_B, BERT_LARGE_L = 8, 512
# BERT's sequence and pooled outputs, the kernels against no_kernels on
# the card, as a share of the largest magnitude: IEEE f32 sums in another
# order (and an online softmax against a two-pass one) through 12 or 24
# post-norm layers. Phase 6's loss through 12 layers agreed to 1e-5
# relative; 1e-4 leaves 10x for the deeper stack
BERT_OUT_TOL = 1e-4
# the vision nets of phase 12 at the input size they fix (Inception 299,
# the rest 224): inference at batch 32 under default, B 2 logits under
# highest against the port on the CPU at RN_CPU_TOL
ZOO_NETS = {"alexnet": 224, "vgg16": 224, "vgg16_bn": 224,
            "squeezenet1.1": 224, "densenet121": 224, "inceptionv3": 299,
            "mobilenet1.0": 224, "mobilenetv2_1.0": 224}
ZOO_B, ZOO_ITERS, ZOO_TRAIN_STEPS = 32, 10, 2
# the model store's models against tests/golden, at the reference's
# tolerance there (tests/test_model_zoo.py)
STORE_GOLDEN_TOL = 2e-4


def bert_flops(b, l, units=768, hidden=3072, layers=12, vocab=30522):
    """Operations (2 per multiply-add) of one BERT pretraining forward:
    per layer the QKV, out and FFN products and attention's QK^T and PV,
    then the MLM transform and tied decoder, the pooler and NSP."""
    per_layer = (4 * units * units + 2 * units * hidden) * b * l \
        + 2 * b * l * l * units
    heads = (units * units + units * vocab) * b * l \
        + (units * units + 2 * units) * b
    return 2 * (layers * per_layer + heads)


def bert_batch(torch, dev, b=None, l=None, seed=SEED + 12):
    """Seeded tokens (B, L) (BERT_B, BERT_L unless given), token types (0
    then 1 on each half) and NSP labels (B,) on the card."""
    b, l = b or BERT_B, l or BERT_L
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tokens = torch.randint(0, BERT_VOCAB, (b, l), generator=g, device=dev)
    types = (torch.arange(l, device=dev) >= l // 2).long().expand(b, l)
    nsp = torch.randint(0, 2, (b,), generator=g, device=dev)
    return tokens, types.contiguous(), nsp


def bert_loss(net, tokens, types, nsp=None):
    """One pretraining forward and backward: per sequence the MLM loss
    over every position (labels the tokens), plus the NSP loss on the
    labels ``nsp`` where given, both SoftmaxCrossEntropyLoss."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    loss_fn = SoftmaxCrossEntropyLoss()
    with autograd.record():
        mlm, nsp_logits = net(tokens, types)
        loss = loss_fn(mlm, tokens)
        if nsp is not None:
            loss = loss + loss_fn(nsp_logits, nsp)
    autograd.backward(loss)
    return loss.detach()


def bert_grads(torch, net, batch, wrappers):
    """(loss, name -> gradient, launches) of one step; the gradients are
    taken off the net."""
    for w in wrappers.values():
        w.launches = 0
    loss = bert_loss(net, *batch)
    grads = {n: p.grad().clone() for n, p in net.collect_params().items()}
    net.zero_grad(set_to_none=True)
    return loss, grads, {k: w.launches for k, w in wrappers.items()}


def bert_grad_check(torch, net, batch, wrappers):
    """One BERT-base step at B 32, L 128 with the MLM and the NSP losses
    through the kernels under highest against the same under
    ``no_kernels`` on the card, at phase 6's
    limits (the loss to 1e-5 relative, each gradient to 1e-3 of its
    largest magnitude), with exact launches and none under no_kernels;
    then the step under default against highest in norm, at phase 9's
    limits (:func:`grads_in_norm`)."""
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.ops import nn as tnn

    with matmul_precision_scope("highest"):
        loss_k, grad_k, counts_k = bert_grads(torch, net, batch, wrappers)
        with tnn.no_kernels():
            loss_p, grad_p, counts_p = bert_grads(torch, net, batch,
                                                  wrappers)
    check(counts_k == BERT_LAUNCHES,
          f"BERT step launched {counts_k} != {BERT_LAUNCHES}")
    check(not any(counts_p.values()), f"no_kernels launched {counts_p}")
    loss_err = ((loss_k - loss_p).abs().max() / loss_p.abs().max()).item()
    worst, worst_name = 0.0, None
    for name, gp in grad_p.items():
        gk = grad_k[name]
        check(torch.isfinite(gk).all().item(), f"{name}: non-finite grad")
        check(gp.abs().max().item() > 0, f"{name}: zero gradient")
        ratio = ((gk - gp).abs().max() / gp.abs().max()).item()
        if ratio > worst:
            worst, worst_name = ratio, name
    print(f"BERT-base step B{BERT_B} L{BERT_L}, kernels vs no_kernels on the "
          f"card (highest): loss relative err {loss_err:.3e} (limit 1e-5); "
          f"{len(grad_p)} gradients, all non-zero, worst max|err| / max|g| "
          f"{worst:.3e} ({worst_name}, limit 1e-3); launches {counts_k}",
          flush=True)
    check(loss_err <= 1e-5, f"BERT loss kernels vs plain: {loss_err}")
    check(worst <= 1e-3, f"BERT gradient {worst_name}: {worst} > 1e-3")
    del grad_p
    with matmul_precision_scope("default"):
        loss_d, grad_d, counts_d = bert_grads(torch, net, batch, wrappers)
    check(counts_d == BERT_LAUNCHES,
          f"default-policy BERT step launched {counts_d}")
    policy = grads_in_norm(
        torch, f"BERT-base B{BERT_B} L{BERT_L} gradients, default vs "
        "highest", (loss_d, grad_d), (loss_k, grad_k), POLICY_LOSS_TOL,
        RN_TF32_GRAD_TOL, RN_TF32_GLOBAL_TOL)
    return {"loss_rel_err": loss_err, "worst_grad_ratio": worst,
            "worst_grad": worst_name, "launches": counts_k,
            "default_vs_highest": policy}


def bert_train(torch, net, init, batch, card, wrappers, policy):
    """BERT-base trains under ``policy`` (set by the caller) from the
    weights ``init`` as the bench does: the MLM loss,
    ``Trainer(net.collect_params(), "sgd", lr 0.05, momentum 0.9)``, a
    warm-up step, then BERT_STEPS timed steps with exact launches and a
    falling loss. Under default one more step is profiled (device ms by
    kind, the busy share), written to
    ``chiprun_out/bert_train_profile.txt``."""
    from mxnet_tpu_torch.gluon import Trainer

    dev = batch[0].device
    params = net.collect_params()
    for n, p in params.items():
        p.set_data(init[n])
    trainer = Trainer(params, "sgd", {"learning_rate": 0.05,
                                      "momentum": 0.9})

    def step():
        loss = bert_loss(net, *batch[:2])
        trainer.step(BERT_B, ignore_stale_grad=True)  # no NSP gradient
        return loss

    first = step().mean().item()                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    losses, host_ms, span_ms = [], [], []
    for _ in range(BERT_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        span_ms.append(start.elapsed_time(end))
        losses.append(loss.mean().item())
    counts = {k: w.launches for k, w in wrappers.items()}
    want = {k: BERT_STEPS * n for k, n in BERT_TRAIN_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(losses)) and np.isfinite(first),
          f"non-finite BERT loss {first} {losses}")
    check(losses[-1] < first, f"BERT loss did not fall: {first} -> {losses}")
    check(counts == want, f"BERT train launches {counts} != {want}")
    step_ms = float(np.mean(host_ms))
    flops = 3 * bert_flops(BERT_B, BERT_L)
    out = {"warmup_loss": first, "losses": losses, "host_ms": host_ms,
           "device_span_ms": span_ms, "step_ms": step_ms,
           "seq_s": BERT_B / step_ms * 1e3,
           "tok_s": BERT_B * BERT_L / step_ms * 1e3,
           "matmul_tflop_per_step": flops / 1e12,
           "max_memory_allocated": peak, "launches": counts,
           "policy": policy, "card": card}
    print(f"BERT-base pretraining on {card}, matmul precision {policy}: "
          f"B{BERT_B} L{BERT_L} SGD momentum 0.9 lr 0.05; MLM loss "
          f"{first:.5f} (warm-up) -> {[round(v, 5) for v in losses]}; step "
          f"ms (host wall to a synchronise) {[round(v, 3) for v in host_ms]}"
          f", device span ms (CUDA events) "
          f"{[round(v, 3) for v in span_ms]}; {out['seq_s']:.1f} seq/s, "
          f"{out['tok_s']:.1f} tokens/s; {flops / 1e12:.3f} TFLOP of "
          f"products a step, {flops / step_ms / 1e9:.1f} TFLOP/s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; launches over "
          f"{BERT_STEPS} steps {counts}", flush=True)
    if policy == "default":
        dev_ms, wall_ms, split = profile_train_step(
            torch, step, "bert_train_profile.txt", named=BERT_KINDS)
        check(dev_ms is not None, "the profiler saw no device time")
        out["profile"] = {"device_ms": dev_ms, "wall_ms": wall_ms,
                          "device_busy": dev_ms / step_ms,
                          "by_kind_ms": split}
        print(f"BERT-base train step (default), profiler: device ms summed "
              f"over kernels {dev_ms:.3f} (wall ms of the profiled step "
              f"{wall_ms:.3f}), device busy {dev_ms / step_ms:.3f} of the "
              f"timed steps' {step_ms:.3f} ms; device ms by kind "
              f"{ {k: round(v, 3) for k, v in split.items()} } (product: "
              "cuBLAS; other: elementwise and copies)", flush=True)
    net.zero_grad(set_to_none=True)
    return out


def bert_nsp_probe(torch, net, init, batch, steps=4):
    """What the bench's settings do to the NSP head: from the weights
    ``init``, ``steps`` SGD steps (lr 0.05, momentum 0.9) on the MLM plus
    the NSP loss, under default. Prints and returns each loss's mean at
    each step; no check."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    tokens, types, nsp = batch
    params = net.collect_params()
    for n, p in params.items():
        p.set_data(init[n])
    trainer = Trainer(params, "sgd", {"learning_rate": 0.05,
                                      "momentum": 0.9})
    loss_fn = SoftmaxCrossEntropyLoss()
    mlm_l, nsp_l = [], []
    with matmul_precision_scope("default"):
        for _ in range(steps):
            with autograd.record():
                mlm, nsp_logits = net(tokens, types)
                lm, ln = loss_fn(mlm, tokens), loss_fn(nsp_logits, nsp)
            autograd.backward(lm + ln)
            trainer.step(BERT_B)
            mlm_l.append(lm.mean().item())
            nsp_l.append(ln.mean().item())
    print(f"BERT-base, {steps} SGD steps (lr 0.05, momentum 0.9) on the MLM "
          f"plus the NSP loss: MLM {[round(v, 4) for v in mlm_l]}, NSP "
          f"{[round(v, 4) for v in nsp_l]} (the loss before each step)",
          flush=True)
    return {"mlm": mlm_l, "nsp": nsp_l}


def bert_held(torch, model, args, what, layers, masked, wrappers):
    """One forward of a BERTModel through the kernels, launches exact
    (K2 2L+1, K1 L unless ``masked``), its sequence and pooled outputs
    held against the same under no_kernels (BERT_OUT_TOL), and timed
    (seq/s from the host ms per call)."""
    from mxnet_tpu_torch.ops import nn as tnn

    with torch.no_grad():
        for w in wrappers.values():
            w.launches = 0
        seq, pooled = model(*args)
        counts = {k: w.launches for k, w in wrappers.items()}
        with tnn.no_kernels():
            pseq, ppooled = model(*args)
        dev_ms, host_ms = time_ms(lambda i: model(*args), iters=10, warmup=2)
    want = dict({k: 0 for k in wrappers}, layer_norm_fwd=2 * layers + 1,
                flash_attention_fwd=0 if masked else layers)
    check(counts == want, f"{what}: launches {counts} != {want}")
    errs = {}
    for part, a, b in (("seq", seq, pseq), ("pooled", pooled, ppooled)):
        check(torch.isfinite(a).all().item(), f"{what} {part}: non-finite")
        errs[part] = ((a - b).abs().max() / b.abs().max()).item()
    b_ = args[0].shape[0]
    print(f"{what}: seq {tuple(seq.shape)} and pooled {tuple(pooled.shape)} "
          f"against no_kernels, max|err| / max|ref| {errs} (limit "
          f"{BERT_OUT_TOL:g}); launches {counts}; host_ms {host_ms:.4f}, "
          f"device_ms {dev_ms:.4f} a forward, {b_ / host_ms * 1e3:.1f} "
          "seq/s", flush=True)
    check(max(errs.values()) <= BERT_OUT_TOL, f"{what}: {errs}")
    return {"rel_err": errs, "launches": counts, "host_ms": host_ms,
            "device_ms": dev_ms, "seq_s": b_ / host_ms * 1e3}


def bert_inference(torch, bert, card, wrappers):
    """BERT inference under highest: the pretraining net's BERTModel at
    B 32, L 128 without valid_length (K1) and with a ragged one (the
    masked plain path), and a fresh bert_large (dropout 0,
    ``initialize()``) at B 8, L 512 (K1 at 16 heads), each held against
    no_kernels (:func:`bert_held`)."""
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_large

    dev = bert.word_embed.weight.data().device
    tokens, types, _ = bert_batch(torch, dev, seed=SEED + 13)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 13)
    valid = torch.randint(1, BERT_L + 1, (BERT_B,), generator=g, device=dev)
    valid[0] = BERT_L
    out = {"card": card}
    with matmul_precision_scope("highest"):
        out["base"] = bert_held(torch, bert, (tokens, types),
                                f"bert_base B{BERT_B} L{BERT_L}", 12, False,
                                wrappers)
        out["base_valid_length"] = bert_held(
            torch, bert, (tokens, types, valid),
            f"bert_base B{BERT_B} L{BERT_L}, valid_length "
            f"{valid.min().item()}..{BERT_L}", 12, True, wrappers)
        large = bert_large(dropout=0.0)
        large.initialize()                            # gpu(0)
        lt, ltypes, _ = bert_batch(torch, dev, BERT_LARGE_B, BERT_LARGE_L,
                                   SEED + 15)
        out["large"] = bert_held(
            torch, large, (lt, ltypes),
            f"bert_large B{BERT_LARGE_B} L{BERT_LARGE_L}", 24, False,
            wrappers)
    del large
    torch.cuda.empty_cache()
    return out


def zoo_vision(torch, card):
    """The other vision families at full width through ``get_model`` and
    ``initialize()`` (gpu(0)), a forward completing the deferred shapes:
    each inference at B 32 under default eager and replayed, a replay
    bitwise the eager call (:func:`resnet_inference`), and B 2 logits
    under highest against the same net on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params, to_jax_params
    from mxnet_tpu_torch.gluon.model_zoo import vision

    dev = mx.context.resolve_device(None)
    rng = np.random.default_rng(SEED + 14)
    out = {}
    for name, size in ZOO_NETS.items():
        net = vision.get_model(name)
        net.initialize()                              # gpu(0)
        x = torch.from_numpy(rng.random((ZOO_B, 3, size, size),
                                        dtype=np.float32)).to(dev)
        with torch.no_grad():
            net(x[:1])                                # completes the shapes
        macs, layers = resnet_macs(torch, net, x)
        torch.cuda.reset_peak_memory_stats(dev)
        with matmul_precision_scope("default"):
            row, eager = resnet_inference(torch, net, x, card, "f32 default",
                                          macs, label=name, iters=ZOO_ITERS)
        peak = torch.cuda.max_memory_allocated(dev)
        net.hybridize(False)
        check(eager.shape == (ZOO_B, 1000) and torch.isfinite(eager).all()
              .item(), f"{name}: logits {tuple(eager.shape)} or non-finite")
        cpu = vision.get_model(name)
        cpu.initialize(device="cpu")
        with torch.no_grad():
            cpu(x[:1].cpu())
            from_jax_params(to_jax_params(net), cpu)
            ref = cpu(x[:2].cpu())
            with matmul_precision_scope("highest"):
                got = net(x[:2]).cpu()
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        print(f"{name}: {macs} multiply-adds per image over {layers} "
              f"convolution and Dense layers; max_memory_allocated at B"
              f"{ZOO_B} {peak / 2**30:.3f} GiB; B 2 logits on the card "
              f"(highest) against the CPU max|err| {err:.4e}, "
              f"{err / scale:.3e} of the largest magnitude (limit "
              f"{RN_CPU_TOL:g})", flush=True)
        check(err <= RN_CPU_TOL * scale, f"{name} card vs CPU: {err}")
        row.update(macs_per_image=macs, max_memory_allocated=peak,
                   cpu_rel_err=err / scale, size=size)
        out[name] = row
        del net, cpu, x, eager
        torch.cuda.empty_cache()
    return out


def zoo_train(torch, card, wrappers):
    """mobilenetv2_1.0 trains at B 32, 224x224, under default: a warm-up
    step, then ZOO_TRAIN_STEPS timed steps of SoftmaxCrossEntropyLoss and
    ``Trainer("sgd", lr 0.05, momentum 0.9)``, the loss falling and K3
    the only kernel of the port, once a step (depthwise convolutions and
    their backward in cuDNN)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision

    dev = mx.context.resolve_device(None)
    rng = np.random.default_rng(SEED + 16)
    x = torch.from_numpy(rng.random((ZOO_B, 3, 224, 224),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, ZOO_B)).to(dev)
    net = vision.mobilenet_v2_1_0()
    net.initialize()
    with torch.no_grad():
        net(x[:1])
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = SoftmaxCrossEntropyLoss()

    def step():
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        trainer.step(ZOO_B)
        return loss.detach().mean().item()

    with matmul_precision_scope("default"):
        first = step()
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        losses, host_ms = [], []
        for _ in range(ZOO_TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(step())
            host_ms.append(1e3 * (time.perf_counter() - t0))
    counts = {k: w.launches for k, w in wrappers.items()}
    want = dict({k: 0 for k in wrappers},
                cross_entropy_lse=ZOO_TRAIN_STEPS)
    print(f"mobilenetv2_1.0 train on {card} (default): B{ZOO_B} 224x224 SGD "
          f"momentum 0.9 lr 0.05; loss {first:.5f} (warm-up) -> "
          f"{[round(v, 5) for v in losses]}; step ms "
          f"{[round(v, 3) for v in host_ms]}, "
          f"{ZOO_B / np.mean(host_ms) * 1e3:.1f} img/s; launches {counts}",
          flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < first,
          f"mobilenetv2_1.0 loss did not fall: {first} -> {losses}")
    check(counts == want, f"mobilenetv2_1.0 launches {counts} != {want}")
    return {"warmup_loss": first, "losses": losses, "host_ms": host_ms,
            "img_s": ZOO_B / np.mean(host_ms) * 1e3, "launches": counts}


def zoo_store(torch, card):
    """``pretrained=True`` on a machine without JAX: resnet18_v1 and
    mobilenetv2_1.0 generated on the host into an empty cache (under
    ``mxnet_tpu_torch/_build/``, removed after), each file's logical
    sha256 equal to the manifest, a second ask served from the cache,
    the nets loaded on the card, and their training-mode logits under
    highest on tests/golden's input equal to the goldens at rtol and
    atol STORE_GOLDEN_TOL."""
    import shutil

    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.gluon.model_zoo import model_store, vision

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "mxnet_tpu_torch", "_build", "model_store")
    shutil.rmtree(root, ignore_errors=True)
    x = np.random.RandomState(1234).uniform(
        -1, 1, size=(2, 3, 224, 224)).astype(np.float32)
    out = {}
    try:
        for name, builder in (("resnet18_v1", vision.resnet18_v1),
                              ("mobilenetv2_1.0", vision.mobilenet_v2_1_0)):
            t0 = time.perf_counter()
            path = model_store.get_model_file(name, root=root)
            gen_s = time.perf_counter() - t0
            sha = model_store._file_sha256(path)
            check(sha == model_store._MODEL_SHA256[name],
                  f"{name}: sha256 {sha} is not the manifest's")
            stamp = os.stat(path).st_mtime_ns
            net = builder(pretrained=True, root=root)        # gpu(0)
            check(os.stat(path).st_mtime_ns == stamp,
                  f"{name}: the cached file was generated again")
            dev = next(iter(net.collect_params().values())).data().device
            check(dev.type == "cuda", f"{name}: loaded on {dev}")
            with matmul_precision_scope("highest"), autograd.record():
                logits = net(torch.from_numpy(x).to(dev)).detach().cpu()
            golden = np.load(os.path.join(here, "tests", "golden",
                                          f"{name}_logits.npz"))["logits"]
            diff = np.abs(logits.numpy() - golden)
            bound = STORE_GOLDEN_TOL * (1 + np.abs(golden))
            print(f"{name} pretrained=True on {card}: generated in "
                  f"{gen_s:.2f} s on the host, sha256 {sha[:16]}... as the "
                  f"manifest; loaded on {dev}; training-mode logits "
                  f"(highest) against tests/golden max|err| "
                  f"{diff.max():.3e}, worst err / (rtol |g| + atol) "
                  f"{(diff / bound).max():.3f} (rtol = atol = "
                  f"{STORE_GOLDEN_TOL:g})", flush=True)
            check(bool((diff <= bound).all()),
                  f"{name}: logits off the goldens by {diff.max()}")
            out[name] = {"generate_s": gen_s, "sha256": sha,
                         "max_abs_err": float(diff.max())}
            del net
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def zoo_phase(torch, card, wrappers):
    """Phase 12: BERT-base pretraining (:func:`bert_grad_check`,
    :func:`bert_train` under highest and default), BERT inference
    (:func:`bert_inference`), the vision families (:func:`zoo_vision`,
    :func:`zoo_train`) and the model store (:func:`zoo_store`)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      bert_base)

    t_phase = time.perf_counter()
    dev = mx.context.resolve_device(None)
    mx.np.random.seed(SEED)
    net = BERTForPretraining(bert_base(dropout=0.0))
    net.initialize()                                  # gpu(0)
    params = net.collect_params()
    init = {n: p.data().detach().clone() for n, p in params.items()}
    n_params = sum(t.numel() for t in init.values())
    per_token = bert_flops(1, BERT_L) / BERT_L
    print(f"BERT-base pretraining net: {len(params)} parameters, {n_params} "
          f"values on {init['mlm_bias'].device}; {per_token / 1e6:.1f} MFLOP "
          "of products per token forward", flush=True)
    batch = bert_batch(torch, dev)
    out = {"card": card, "params": n_params,
           "grad_check": bert_grad_check(torch, net, batch, wrappers)}
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            out[f"train_{policy}"] = bert_train(torch, net, init, batch, card,
                                                wrappers, policy)
    out["nsp_probe"] = bert_nsp_probe(torch, net, init, batch)
    out["inference"] = bert_inference(torch, net.bert, card, wrappers)
    del net, init, batch
    torch.cuda.empty_cache()
    out["vision"] = zoo_vision(torch, card)
    out["vision_train"] = zoo_train(torch, card, wrappers)
    out["store"] = zoo_store(torch, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 12 took {out['seconds']:.1f} s on {card}", flush=True)
    return out


def bert_row_launches(rows, zoo):
    """The launches of phase 2's rows at BERT's shapes: those of phase 12's
    timed steps under their policy (K3 at the MLM logits' shape one a
    step; at NSP's, those of the checked step)."""
    for row in rows:
        if f"B{BERT_B} H12 L{BERT_L} " in row["case"]:
            one = row["name"].endswith("_tf32")
            train = zoo["train_default" if one else "train_highest"]
            row["launches"] = train["launches"][
                row["name"].removesuffix("_tf32")]
        elif row["case"].startswith(f"({BERT_B * BERT_L}, "):
            row["launches"] = BERT_STEPS           # the MLM loss's
        elif row["case"].endswith("unaligned rows"):
            # the NSP loss's: the checked step, under highest and default
            row["launches"] = 2


# -- phase 13: LLMEngine's single-engine options -------------------------
# the resumed session of benchmark/kv_economy_bench.py:188-245 at full
# width: block 16, int8 KV, 4 lanes, max_context 1024 (the default pool of
# 4 x 64 = 256 blocks); a 968-token session (60 full blocks) takes 2 new
# tokens, then each round a flood of 5 distinct 968-token prompts (61
# blocks each: 305 > 256) evicts it and the session resumes; the first
# resume is untimed (it captures the suffix bucket)
OPT_BS, OPT_LANES, OPT_CONTEXT, OPT_SESSION = 16, 4, 1024, 968
OPT_FLOOD, OPT_RESUMES, OPT_DISK_RESUMES = 5, 5, 2
OPT_DISK_BYTES = 8 << 20
# beam search: B 2, beam 4, 128-token prompts, 32 new tokens; against the
# port on the CPU at 8
OPT_BEAM_B, OPT_BEAM_K, OPT_BEAM_P, OPT_BEAM_CPU = 2, 4, 128, 8
OPT_BEAM_TOL = 1e-4


def serve_prompts():
    """Phase 3's 8 prompts: 16..1024 seeded tokens."""
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(16, 1025, size=8)
    return lens, [rng.integers(0, CFG["vocab_size"], size=int(p))
                  .astype(np.int32) for p in lens]


def expected_launches(wrappers, full=0, suffix=0, steps=0):
    """Launches of ``full`` full prefills (2L+1 K2), ``suffix`` suffix
    prefills and ``steps`` decode steps (L each of K4, K5a and K5b, and
    2L+1 K2)."""
    layers = CFG["num_layers"]
    per = layers * (suffix + steps)
    return dict({k: 0 for k in wrappers},
                layer_norm_fwd=(2 * layers + 1) * (full + suffix + steps),
                paged_attention=per, qkv_project=per, out_project=per)


def load_dequantized(torch, src, dst):
    """Load ``dequantize(quantize(W))`` of ``src``'s weights into
    ``dst``: bitwise the weights an int8-weight step computes with."""
    from mxnet_tpu_torch.contrib.quantization import (
        dequantize_weights_int8, quantize_weights_int8)

    params = {n: p.data() for n, p in src.collect_params().items()}
    deq = dequantize_weights_int8(*quantize_weights_int8(params))
    with torch.no_grad():
        for n, p in dst.collect_params().items():
            p.data().copy_(deq[n])


def serve_engine(torch, eng, prompts, wrappers):
    """Warm ``eng`` on the prompts' lengths, one untimed request, then
    the prompts submitted together: (tokens, wall s, launches, stats
    before, stats after, warmed buckets)."""
    buckets = eng.warmup([len(p) for p in prompts])
    eng.generate(prompts[0][:16], 4)
    before = eng.stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    outs = [h.wait(timeout=600) for h in [eng.submit(p, NEW_TOKENS)
                                          for p in prompts]]
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    return outs, wall, counts, before, eng.stats(), buckets


def options_int8(torch, card, wrappers, model, model_dq):
    """Phase 13, int8 weights: the int8-weight engine against the plain
    engine over ``dequantize(quantize(W))`` weights (token for token) and
    the f32-weight engine (tok/s, peak memory) on phase 3's workload,
    exact launches, an f32-KV engine against the dense ``generate``, a
    replay against an eager call, and the decode step's times."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        generate, paged_decode_program)
    from mxnet_tpu_torch.serving.llm import LLMEngine

    lens, prompts = serve_prompts()
    out = {}
    toks = {}
    for name, net, kw in (("f32", model, {}),
                          ("int8", model, dict(weight_dtype="int8")),
                          ("dequantized", model_dq, {})):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        with LLMEngine(net, **kw) as eng:
            outs, wall, counts, before, after, buckets = serve_engine(
                torch, eng, prompts, wrappers)
            # a graph's pool keeps its blocks reserved between replays
            reserved = torch.cuda.memory_reserved() - base_reserved
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        steps = (after["counters"]["decode_steps"]
                 - before["counters"]["decode_steps"])
        prefills = (after["counters"]["prefills"]
                    - before["counters"]["prefills"])
        expected = expected_launches(wrappers, full=prefills, steps=steps)
        dec_s = after["decode_s"] - before["decode_s"]
        row = {"tok_s": len(prompts) * NEW_TOKENS / wall, "wall_s": wall,
               "decode_step_host_ms": 1e3 * dec_s / steps,
               "decode_tok_s": (after["decode_tokens"]
                                - before["decode_tokens"]) / dec_s,
               "prefills": prefills, "decode_steps": steps,
               "launches": counts, "peak_bytes": peak,
               "reserved_bytes": reserved,
               "graph_captures": after["graphs"]["captures"]}
        if name == "int8":
            row["int8_weights"] = after["int8_weights"]
        print(f"{name}-weight engine on {card}: {len(prompts)} requests, "
              f"{row['tok_s']:.1f} tok/s end to end, decode "
              f"{row['decode_tok_s']:.1f} tok/s, {steps} steps of "
              f"{row['decode_step_host_ms']:.3f} host ms, peak memory "
              f"{peak / 2**20:.1f} MiB allocated above the model, "
              f"{reserved / 2**20:.1f} MiB reserved while serving (the "
              f"graphs' pools); launches {counts}, "
              f"expected {expected}", flush=True)
        check(prefills == len(prompts) and counts == expected,
              f"{name}: launches {counts} != {expected}")
        check(after["graphs"]["captures"] == before["graphs"]["captures"],
              f"{name}: the served run captured a graph")
        toks[name] = outs
        out[name] = row
    iw = out["int8"]["int8_weights"]
    print(f"int8 weights: {iw['bytes']} bytes of codes and "
          f"{iw['scale_bytes']} of scales, quantized in "
          f"{iw['quantize_s']:.3f} s", flush=True)
    for i, (a_, b_) in enumerate(zip(toks["int8"], toks["dequantized"])):
        check(np.array_equal(a_, b_), f"request {i}: int8-weight engine "
              f"{a_.tolist()} != dequantized-weight engine {b_.tolist()}")
    same_f32 = sum(np.array_equal(a_, b_)
                   for a_, b_ in zip(toks["int8"], toks["f32"]))
    print(f"int8-weight engine == engine over dequantize(quantize(W)): "
          f"tokens identical on {len(prompts)} requests; equal to the "
          f"f32-weight engine's on {same_f32}", flush=True)
    out["requests_equal_f32"] = same_f32

    check_prompts = [prompts[1][:40], prompts[2][:23]]
    with LLMEngine(model, kv_cache_dtype="float32",
                   weight_dtype="int8") as eng:
        paged = [eng.generate(p, 8) for p in check_prompts]
    dense = [generate(model, p[None], 8, weight_dtype="int8").cpu()
             .numpy()[0] for p in check_prompts]
    for a_, b_ in zip(paged, dense):
        check(np.array_equal(a_, b_), f"f32-KV int8-weight engine "
              f"{a_.tolist()} != dense generate {b_.tolist()}")
    print("int8-weight engine (f32 KV) == dense generate(weight_dtype="
          "'int8'): greedy tokens identical on 2 prompts x 8 tokens",
          flush=True)

    g = torch.Generator(device=model.word_embed.weight.data().device)
    g.manual_seed(SEED + 13)
    args = decode_state(torch, model, lens + NEW_TOKENS // 2, g)
    tk, pk, pv, table, pos = args
    run8 = paged_decode_program(model, weight_dtype="int8")
    run32 = paged_decode_program(model)
    out["replay_vs_eager"] = replays_equal_eager(torch, wrappers, (
        ("int8-weight decode", run8, (pk, pv),
         expected_launches(wrappers, steps=1),
         lambda call, k_, v_: call(tk, k_, v_, table, pos, g)),))
    step = {}
    for name, run in (("int8", run8), ("f32", run32)):
        dev_ms, host_ms = time_ms(lambda i: run(*args, g), iters=10,
                                  warmup=2)
        step[name] = {"device_ms": dev_ms, "host_ms": host_ms}
        print(f"decode step on {card}, {name} weights, replayed: device_ms "
              f"{dev_ms:.4f} host_ms {host_ms:.4f}", flush=True)
    out["decode_step"] = step
    del args, pk, pv, run8, run32
    return out


def options_beam(torch, card, wrappers, model, cpu_model):
    """Phase 13, beam search with f32 and int8 weights: the kernels
    against ``no_kernels()`` on the card at 32 new tokens, the card
    against the port on the CPU at 8, an eos that fires, exact K2
    launches and the time per generated token."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import beam_search
    from mxnet_tpu_torch.ops import nn as tnn

    rng = np.random.default_rng(SEED + 14)
    prompt = rng.integers(0, CFG["vocab_size"], (OPT_BEAM_B, OPT_BEAM_P)
                          ).astype(np.int32)
    layers = CFG["num_layers"]
    out = {}
    for wd in (None, "int8"):
        name = wd or "f32"
        kw = dict(beam_size=OPT_BEAM_K, weight_dtype=wd)
        # eos: the best beam's third token of a run without one
        eos = int(beam_search(model, prompt, 3, **kw)[0][0, 0, 2])
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seqs, scores = beam_search(model, prompt, NEW_TOKENS,
                                   eos_token=eos, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        expected = dict({k: 0 for k in wrappers},
                        layer_norm_fwd=(2 * layers + 1) * NEW_TOKENS)
        check(counts == expected, f"beam {name}: launches {counts} != "
              f"{expected}")
        with tnn.no_kernels():
            seqs_p, scores_p = beam_search(model, prompt, NEW_TOKENS,
                                           eos_token=eos, **kw)
        err = (scores - scores_p).abs().max().item()
        check(torch.equal(seqs, seqs_p) and err <= OPT_BEAM_TOL,
              f"beam {name}: kernels vs plain sequences "
              f"{torch.equal(seqs, seqs_p)}, scores err {err}")
        s = seqs.cpu().numpy()
        fired = int(((s[..., :-1] == eos) & (s[..., 1:] == eos)).any(-1)
                    .sum())
        check(fired > 0, f"beam {name}: eos {eos} never fired")
        seqs8, scores8 = beam_search(model, prompt, OPT_BEAM_CPU,
                                     eos_token=eos, **kw)
        seqs_c, scores_c = beam_search(cpu_model, prompt, OPT_BEAM_CPU,
                                       eos_token=eos, device="cpu", **kw)
        err_c = (scores8.cpu() - scores_c).abs().max().item()
        check(torch.equal(seqs8.cpu(), seqs_c) and err_c <= OPT_BEAM_TOL,
              f"beam {name}: card vs CPU sequences "
              f"{torch.equal(seqs8.cpu(), seqs_c)}, scores err {err_c}")
        ms_tok = 1e3 * wall / (OPT_BEAM_B * NEW_TOKENS)
        out[name] = {"eos": eos, "beams_fired": fired, "wall_s": wall,
                     "ms_per_token": ms_tok, "plain_err": err,
                     "cpu_err": err_c, "launches": counts}
        print(f"beam search on {card}, {name} weights (B {OPT_BEAM_B}, "
              f"beam {OPT_BEAM_K}, prompt {OPT_BEAM_P}, {NEW_TOKENS} new): "
              f"{ms_tok:.3f} ms per generated token (of a batch row), eos "
              f"{eos} fired in {fired} beams, scores against no_kernels "
              f"{err:.2e} and against the CPU at {OPT_BEAM_CPU} tokens "
              f"{err_c:.2e} (tol {OPT_BEAM_TOL:g}); launches {counts}",
              flush=True)
    return out


def reattached(eng, tier):
    """Blocks ``eng`` re-attached from ``tier`` so far (its registry
    series)."""
    from mxnet_tpu_torch.telemetry import get_registry

    fam = get_registry().snapshot()["metrics"].get("llm_kv_reattach_total")
    return sum(s["value"] for s in (fam or {}).get("series", ())
               if s["labels"] == {"engine": eng.metrics.engine_id,
                                  "tier": tier})


def options_spill(torch, card, wrappers, model, tier, resumes, kw):
    """Phase 13, the resumed session on one engine (``tier`` the spill
    tier it re-attaches from, None for an engine without spill): the
    first turn, then ``resumes`` rounds of a flood and a resume; each
    resume's tokens equal the first turn's, a spill engine re-attaches
    the session's 60 full blocks from ``tier`` byte-equal to the rows
    the first turn wrote, and the resume's launches are exact."""
    from mxnet_tpu_torch.serving.kv_hash import chain_hashes
    from mxnet_tpu_torch.serving.llm import LLMEngine

    rng = np.random.default_rng(SEED + 15)
    vocab = CFG["vocab_size"]
    session = rng.integers(0, vocab, OPT_SESSION).astype(np.int32)
    floods = [[rng.integers(0, vocab, OPT_SESSION).astype(np.int32)
               for _ in range(OPT_FLOOD)] for _ in range(resumes + 1)]
    full = OPT_SESSION // OPT_BS
    ttft, row = [], {"tier": tier}
    with LLMEngine(model, block_size=OPT_BS, max_running=OPT_LANES,
                   max_context=OPT_CONTEXT, prefix_cache=True, **kw) as eng:
        eng.warmup([OPT_SESSION])
        first = eng.generate(session, 2)
        with eng._state_lock:
            ids = torch.tensor([eng._prefix[h] for h in
                                chain_hashes(session, OPT_BS)[:full]],
                               device=eng._pool_k.device)
            rows = [p.index_select(1, ids).cpu()
                    for p in (eng._pool_k, eng._pool_v)]
        for r in range(resumes + 1):
            for p in floods[r]:
                eng.generate(p, 2)
            before = eng.stats()
            att0 = reattached(eng, tier) if tier else 0
            for w in wrappers.values():
                w.launches = 0
            stamp = []
            t0 = time.perf_counter()
            got = eng.submit(session, 2, on_token=lambda t: stamp.append(
                time.perf_counter() - t0) if not stamp else None).wait(
                    timeout=600)
            counts = {k: w.launches for k, w in wrappers.items()}
            after = eng.stats()
            check(np.array_equal(got, first), f"resume {r} ({tier}): "
                  f"{got.tolist()} != first turn {first.tolist()}")
            c0, c1 = before["counters"], after["counters"]
            hit = (after["prefix_cache"]["hit_requests"]
                   - before["prefix_cache"]["hit_requests"])
            steps = c1["decode_steps"] - c0["decode_steps"]
            check(c1["prefills"] - c0["prefills"] == 1,
                  f"resume {r}: {c1['prefills'] - c0['prefills']} prefills")
            # the first resume captures the suffix bucket: its warm-up
            # call launches once more than the replays count
            expected = expected_launches(wrappers, full=1 - hit,
                                         suffix=hit, steps=steps)
            check(not r or (counts == expected
                            and after["graphs"]["captures"]
                            == before["graphs"]["captures"]),
                  f"resume {r} ({tier}): launches {counts} != {expected}")
            if tier:
                n = reattached(eng, tier) - att0
                check(n == full and hit == 1,
                      f"resume {r}: {n} blocks re-attached from {tier}, "
                      f"prefix hit {hit}")
                with eng._state_lock:
                    ids = torch.tensor(
                        [eng._prefix[h] for h in
                         chain_hashes(session, OPT_BS)[:full]],
                        device=eng._pool_k.device)
                    same = all(torch.equal(p.index_select(1, ids).cpu(), w)
                               for p, w in zip((eng._pool_k, eng._pool_v),
                                               rows))
                check(same, f"resume {r}: re-attached pool rows differ "
                      "from the first turn's")
            if r:               # the first resume captures the suffix graph
                ttft.append(1e3 * stamp[0])
        st = eng.stats()
    row.update(ttft_ms=sorted(ttft), ttft_median_ms=float(np.median(ttft)),
               first=first.tolist())
    if tier:
        sp = st["kv_spill"]
        row.update(save_mb_s=sp["save_bytes"] / sp["save_s"] / 1e6,
                   reattach_mb_s=(sp["reattach_bytes"] / sp["reattach_s"]
                                  / 1e6), save_bytes=sp["save_bytes"],
                   reattach_bytes=sp["reattach_bytes"],
                   demoted_to_disk=sp["demoted_to_disk"],
                   dropped=sp["dropped"])
    print(f"resumed session ({OPT_SESSION} tokens, {full} full blocks) on "
          f"{card}, {tier or 'no'} spill: median time to first token "
          f"{row['ttft_median_ms']:.3f} ms over {len(ttft)} resumes "
          f"{[round(t, 3) for t in row['ttft_ms']]}"
          + (f"; save {row['save_mb_s']:.1f} MB/s, re-attach "
             f"{row['reattach_mb_s']:.1f} MB/s, {row['demoted_to_disk']} "
             f"blocks demoted to disk" if tier else ""), flush=True)
    return row


def options_seams(torch, card, wrappers, model, tmp):
    """Phase 13, the engine's seams on the card: the metrics against
    ``stats()``, the trace ids on every decode span, the step hook once
    per tick, a chaos fault that fails exactly one request typed, and a
    saved manifest that warms a second engine to capture nothing new."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import TransientError
    from mxnet_tpu_torch.resilience import chaos
    from mxnet_tpu_torch.serving.llm import LLMEngine

    _, prompts = serve_prompts()
    prompts = [p[:96] for p in prompts[:4]]
    hooks, ticks = [], []
    out = {}
    path = os.path.join(tmp, "manifest.json")
    with LLMEngine(model, step_hook=lambda: hooks.append(1)) as eng:
        real_tick = eng._tick

        def counted():          # the hook calls each tick makes
            h0 = len(hooks)
            try:
                return real_tick()
            finally:
                ticks.append(len(hooks) - h0)

        eng._tick = counted
        n0 = len(telemetry.buffer().snapshot())
        ids = [f"opt-{i}" for i in range(len(prompts))]
        want = [h.wait(timeout=600) for h in [
            eng.submit(p, 8, trace_id=t) for p, t in zip(prompts, ids)]]
        st = eng.stats()
        m = eng.metrics
        spans = [e for e in telemetry.buffer().snapshot()[n0:]
                 if e["name"] == "step[llm_decode]"]
        counters = m.counters()
        check(counters == st["counters"]
              and counters["decode_steps"] == st["decode_step_ms"]["count"]
              == len(spans)
              and counters["prefills"] == st["prefill_ms"]["count"]
              and int(m.tokens_decode.value) == st["decode_tokens"]
              and int(m.lanes_active.get()) == st["lanes_active"] == 0
              and int(m.pool_free.get()) == st["pool_blocks_free"],
              f"metrics {counters} against stats() {st['counters']}")
        check(all(e["args"].get("trace_ids") and set(e["args"]["trace_ids"])
                  <= set(ids) for e in spans)
              and set().union(*(e["args"]["trace_ids"] for e in spans))
              == set(ids), "a decode span without its lanes' trace ids")
        with chaos.scope("serving.llm", fail="transient", times=1):
            hs = [eng.submit(p, 8) for p in prompts]
            faulted, served = [], []
            for i, h in enumerate(hs):
                try:
                    served.append((i, h.wait(timeout=600)))
                except TransientError as e:
                    faulted.append((i, type(e).__name__))
        check(len(faulted) == 1 and all(np.array_equal(t, want[i])
                                        for i, t in served),
              f"chaos: faulted {faulted}, the others equal an unfaulted "
              f"run: {[np.array_equal(t, want[i]) for i, t in served]}")
        eng.save_warmup_manifest(path)
        buckets = eng.stats()["graphs"]["prefill_buckets"]
    check(ticks and all(n == 1 for n in ticks),
          f"step hook calls per tick: {sorted(set(ticks))}")
    with LLMEngine(model) as eng:
        warmed = eng.warmup(manifest=path)
        cap0 = eng.stats()["graphs"]["captures"]
        again = [eng.generate(p, 8) for p in prompts]
        cap1 = eng.stats()["graphs"]["captures"]
    check(warmed == buckets and cap1 == cap0
          and all(np.array_equal(a_, b_) for a_, b_ in zip(again, want)),
          f"manifest warmup: buckets {warmed} vs {buckets}, captures "
          f"{cap0} -> {cap1}")
    out.update(decode_spans=len(spans), ticks=len(ticks),
               chaos_faulted=faulted, manifest_buckets=warmed)
    print(f"seams on {card}: metrics agree with stats(); {len(spans)} "
          f"decode spans carry their lanes' trace ids; the step hook ran "
          f"once in each of {len(ticks)} ticks; chaos serving.llm failed "
          f"request {faulted} typed and the other {len(served)} equal an "
          f"unfaulted run; a saved manifest warmed buckets {warmed} and "
          f"serving captured nothing new", flush=True)
    return out


def options_sgd(torch, model, model_dq):
    """Phase 13, after one in-place SGD step on the model:
    ``generate(weight_dtype="int8")`` quantizes once over two calls and
    gives the tokens of the model's new dequantized weights."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.model_zoo import generation as gen_mod

    _, prompts = serve_prompts()
    p = prompts[1][:40][None]
    dev = model.word_embed.weight.data().device
    old = gen_mod.generate(model, p, 8, weight_dtype="int8")
    tr = Trainer(model.collect_params(), "sgd", {"learning_rate": 0.5})
    train_loss(model, torch.from_numpy(prompts[7][:256][None]).long()
               .to(dev))
    tr.step(1)
    calls, real = [], gen_mod.quantize_weights_int8
    gen_mod.quantize_weights_int8 = lambda ps: calls.append(1) or real(ps)
    try:
        a = gen_mod.generate(model, p, 8, weight_dtype="int8")
        b = gen_mod.generate(model, p, 8, weight_dtype="int8")
    finally:
        gen_mod.quantize_weights_int8 = real
    load_dequantized(torch, model, model_dq)
    want = gen_mod.generate(model_dq, p, 8)
    check(len(calls) == 1 and torch.equal(a, b) and torch.equal(a, want),
          f"after an SGD step: {len(calls)} quantizations, tokens "
          f"{a.tolist()} vs the new dequantized weights' {want.tolist()}")
    print(f"after one in-place SGD step: generate(weight_dtype='int8') "
          f"quantized once over two calls and follows the new weights "
          f"({old.tolist()} -> {a.tolist()})", flush=True)
    return {"quantizations": len(calls), "before": old.tolist(),
            "after": a.tolist()}


def options_phase(torch, card, wrappers):
    """Phase 13: LLMEngine's single-engine options at full width
    (:func:`options_int8`, :func:`options_beam`, :func:`options_spill`,
    :func:`options_seams`, :func:`options_sgd`)."""
    import tempfile

    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like

    t_phase = time.perf_counter()
    model = gpt_like(**CFG)
    weights = seeded_params(model, SEED)
    model_dq, cpu_model = gpt_like(**CFG), gpt_like(device="cpu", **CFG)
    for net in (model, model_dq, cpu_model):
        from_jax_params(weights, net)
    load_dequantized(torch, model, model_dq)
    out = {"card": card}
    out["int8"] = options_int8(torch, card, wrappers, model, model_dq)
    out["beam"] = options_beam(torch, card, wrappers, model, cpu_model)
    del cpu_model
    spill = dict(kv_spill=True)
    with tempfile.TemporaryDirectory() as tmp:
        out["spill_host"] = options_spill(torch, card, wrappers, model,
                                          "host", OPT_RESUMES, spill)
        out["spill_none"] = options_spill(torch, card, wrappers, model,
                                          None, OPT_RESUMES, {})
        out["spill_disk"] = options_spill(
            torch, card, wrappers, model, "disk", OPT_DISK_RESUMES,
            dict(spill, kv_spill_bytes=OPT_DISK_BYTES,
                 kv_spill_dir=os.path.join(tmp, "spill")))
        check(out["spill_host"]["first"] == out["spill_none"]["first"]
              == out["spill_disk"]["first"],
              "the session's tokens differ between the spill engines")
        out["seams"] = options_seams(torch, card, wrappers, model, tmp)
    out["sgd"] = options_sgd(torch, model, model_dq)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 13 took {out['seconds']:.1f} s", flush=True)
    return out


def serve_one(root, rounds):
    """Phase 3's workload on the engine of the port found under
    ``root`` (a tree holding ``mxnet_tpu_torch/``), imported from there:
    its kernels built, gpt_like at full width with seeded weights, the
    8 requests served ``rounds`` times after ``warmup`` and a warm-up
    request. Prints one ``SERVE_ONE {...}`` line: per round the engine's
    host ms per decode step (``decode_s`` over the steps), the end to
    end tok/s and the decode tok/s."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import mxnet_tpu_torch
    from mxnet_tpu_torch.base import set_matmul_precision
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.serving.llm import LLMEngine

    check(os.path.dirname(os.path.abspath(mxnet_tpu_torch.__file__))
          == os.path.join(root, "mxnet_tpu_torch"),
          f"imported {mxnet_tpu_torch.__file__}, not {root}'s port")
    set_matmul_precision("highest")
    _build.build_all()
    model = gpt_like(**CFG)
    from_jax_params(seeded_params(model, SEED), model)
    _, prompts = serve_prompts()
    out = []
    with LLMEngine(model) as eng:
        eng.warmup([len(p) for p in prompts])
        eng.generate(prompts[0][:16], 4)
        for _ in range(rounds):
            before = eng.stats()
            t0 = time.perf_counter()
            for h in [eng.submit(p, NEW_TOKENS) for p in prompts]:
                h.wait(timeout=600)
            wall = time.perf_counter() - t0
            after = eng.stats()
            steps = (after["counters"]["decode_steps"]
                     - before["counters"]["decode_steps"])
            dec_s = after["decode_s"] - before["decode_s"]
            out.append({
                "decode_host_ms": 1e3 * dec_s / steps,
                "tok_s": len(prompts) * NEW_TOKENS / wall,
                "decode_tok_s": (after["decode_tokens"]
                                 - before["decode_tokens"]) / dec_s})
    print("SERVE_ONE " + json.dumps({"root": root, "rounds": out}),
          flush=True)
    return 0


def serve_ab(roots, rounds, card):
    """Phase 3's workload served by each root's engine in turn, each in
    a process of its own (:func:`serve_one`), on this card: list two
    versions as A B B A. Prints each run's medians and writes them all
    to ``chiprun_out/serve_ab.json``."""
    runs = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             f"--serve-one={root}", f"--rounds={rounds}"],
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("SERVE_ONE ")]
        check(proc.returncode == 0 and len(lines) == 1,
              f"serve-one {root} exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        run = json.loads(lines[0][len("SERVE_ONE "):])
        med = {k: float(np.median([r[k] for r in run["rounds"]]))
               for k in run["rounds"][0]}
        run["median"] = med
        runs.append(run)
        print(f"serve {root} on {card}, median of {rounds} rounds: "
              f"decode host ms per step {med['decode_host_ms']:.4f}, "
              f"tok_s {med['tok_s']:.1f}, decode tok_s "
              f"{med['decode_tok_s']:.1f}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "serve_ab.json"), "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)
    return 0


def write_results(results):
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)


# K5b's ring route without its products (the loop over a share of U_in
# runs no iteration), without the activations' copy, without the
# weights' copies
K5B_NO_FMA = ("for (int j = lane + 32 * warp; j < nvec; j += 32 * OUT_WARPS) {",
              "for (int j = lane + 32 * warp; j < 0; j += 32 * OUT_WARPS) {")
K5B_NO_X = ("u_in * sizeof(T));\n    mbar_expect_tx(xbar, bytes);\n",
            "u_in * sizeof(T));\n    mbar_expect_tx(xbar, 0);\n    return;\n")
K5B_NO_W = (
    "    mbar_expect_tx(bar0 + 8 * slot, bytes);\n"
    "    bulk_g2s(ring + (size_t)slot * stage_rows * u_in,\n"
    "             w + (int64_t)(o0 + r0) * u_in, bytes, bar0 + 8 * slot);\n",
    "    mbar_expect_tx(bar0 + 8 * slot, 0);\n")


def k5b_const(name, value):
    """The substitution (a pattern) that sets one of K5b's constants in
    fused_decode.cu."""
    return (re.compile(rf"constexpr int {name} = \d+;"),
            f"constexpr int {name} = {value};")


# --trials: builds of a source with one constant changed, timed against
# each other in one run. (source, label, [(text, replacement)])
TRIALS = (
    ("paged_attention", "span 4", [("constexpr int PA_SPAN = 8;",
                                    "constexpr int PA_SPAN = 4;")]),
    ("paged_attention", "span 8 (the source)", []),
    ("paged_attention", "span 16", [("constexpr int PA_SPAN = 8;",
                                     "constexpr int PA_SPAN = 16;")]),
    ("flash_attention", "32-row K/V tiles, 3 blocks per SM at D 64 (the "
     "source)", []),
    ("flash_attention", "64-row K/V tiles", [
        ("template <int DP> constexpr int FWD_N = Tile<DP>::N;",
         "template <int DP> constexpr int FWD_N = 64;")]),
    ("flash_attention", "4 blocks per SM at D 64", [
        ("__launch_bounds__(FA_THREADS, Tile<DP>::MIN_BLOCKS)\n"
         "flash_fwd_tc_kernel",
         "__launch_bounds__(FA_THREADS, DP <= 64 ? 4 : 1)\n"
         "flash_fwd_tc_kernel")]),
    ("fused_decode", "K5a cluster of 2", [
        ("constexpr int QKV_CLUSTER = 3;", "constexpr int QKV_CLUSTER = 2;")]),
    ("fused_decode", "K5a cluster of 3, 384 threads (the source)", []),
    ("fused_decode", "K5a cluster of 4", [
        ("constexpr int QKV_CLUSTER = 3;", "constexpr int QKV_CLUSTER = 4;")]),
    ("fused_decode", "K5a cluster of 8", [
        ("constexpr int QKV_CLUSTER = 3;", "constexpr int QKV_CLUSTER = 8;")]),
    ("fused_decode", "K5a cluster of 3, 256 threads", [
        ("constexpr int CL_THREADS = 384;", "constexpr int CL_THREADS = 256;")]),
    ("fused_decode", "K5a cluster of 3, the slab in one bulk copy", [
        ("constexpr int W_CHUNKS = 4;", "constexpr int W_CHUNKS = 1;")]),
    # diagnostic builds (results not checked): the launch and scheduling
    # of the clusters alone, and the copies, waits and epilogue without
    # the products
    ("fused_decode", "diagnostic: K5a returning at entry", [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  if (n_tok >= 0) return;\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n")]),
    ("fused_decode", "diagnostic: K5a without the products", [
        ("for (int j = lane + 32 * p; j < nvec; j += 32 * parts) {",
         "for (int j = lane + 32 * p; j < 0; j += 32 * parts) {")]),
    # K5b: rows a block owns (R), bulk copies of the slab (S), threads,
    # copies of the activations; the row route (out_kernel) for every
    # shape; and diagnostic builds of the ring route (results not
    # checked): the launch alone, and the copies, waits and epilogue
    # without the products, and without either copy
    *(("fused_decode", f"K5b R {r}", [k5b_const("OUT_ROWS", r)])
      for r in (4, 8, 12)),
    ("fused_decode", "K5b R 6, 1 stage, 256 threads, the activations in 4 "
     "copies (the source)", []),
    ("fused_decode", "K5b 2 stages", [k5b_const("OUT_STAGES", 2)]),
    ("fused_decode", "K5b R 12, 3 stages", [k5b_const("OUT_ROWS", 12),
                                            k5b_const("OUT_STAGES", 4)]),
    *(("fused_decode", f"K5b {t} threads",
       [k5b_const("OUT_RING_THREADS", t)]) for t in (128, 384)),
    *(("fused_decode", f"K5b the activations in {c} cop"
       f"{'ies' if c > 1 else 'y'}", [k5b_const("OUT_X_COPIES", c)])
      for c in (1, 8)),
    ("fused_decode", "K5b on the row route (out_kernel)", [
        ("      g.route = 1;\n", "      g.route = 0;\n")]),
    ("fused_decode", "diagnostic: K5b returning at entry", [
        ("  const int o0 = blockIdx.x * geo.rows;",
         "  if (n_tok >= 0) return;\n  const int o0 = blockIdx.x * geo.rows;")]),
    ("fused_decode", "diagnostic: K5b without the products", [K5B_NO_FMA]),
    ("fused_decode", "diagnostic: K5b without the products or the "
     "activations' copy", [K5B_NO_FMA, K5B_NO_X]),
    ("fused_decode", "diagnostic: K5b without the products or the weights' "
     "copies", [K5B_NO_FMA, K5B_NO_W]),
)


def trial_builds(trials):
    """Build each trial's copy of its source (one nvcc each, all started
    together) under mxnet_tpu_torch/_build/trials; returns the loaded
    libraries, with the entry points' argtypes set, and the ptxas lines."""
    import ctypes

    from mxnet_tpu_torch.ops.kernels import _build

    out = _build._OUT / "trials"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (name, label, subs) in enumerate(trials):
        src = (_build._SRC / f"{name}.cu").read_text()
        for old, new in subs:
            if isinstance(old, re.Pattern):
                src, hits = old.subn(new, src)
            else:
                hits = src.count(old)
                src = src.replace(old, new)
            check(hits > 0, f"trial {label}: {old!r} not in {name}.cu")
        cu, lib = out / f"{name}-{i}.cu", out / f"lib{name}-{i}.so"
        cu.write_text(src)
        procs.append((subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._SRC),
             "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib))
    libs, logs = [], []
    for (name, label, _), (proc, lib) in zip(trials, procs):
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"trial {label}: nvcc failed\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build._SIGNATURES[name].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs.append(cdll)
        logs.append(ptxas_summary(log))
        for fn, regs, spill in logs[-1]:
            print(f"  trial {name} [{label}] ptxas {fn}: {regs}; {spill}")
    return libs, logs


def trial_phase(torch, dev, only=""):
    """``--trials``: the K4 span, K1 forward's tiling, K5a's cluster size
    and K5b's rows, stages and threads, each build timed twice, in turns,
    at the shapes the main paths give them, after a check against the
    plain version. ``--trials=K5b`` runs only the trials whose label
    holds ``K5b``."""
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.ops.kernels import flash_attention as kfa
    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd
    from mxnet_tpu_torch.ops.kernels import paged_attention as kpa

    trials = [t for t in TRIALS if only in t[1]]
    libs, logs = trial_builds(trials)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 9)
    heads, d, bs, r, mb = 12, 64, 16, 8, 128
    table = (torch.randperm(r * mb, generator=g, device=dev)
             .reshape(r, mb).to(torch.int32).contiguous())
    q = torch.randn(r, heads, d, generator=g, device=dev)
    pools = {}
    for kind, n_sets in (("int8", 4), ("float32", 2)):
        pools[kind] = []
        for _ in range(n_sets):
            kp, vp = (torch.randn(r * mb + 1, heads, bs, d, generator=g,
                                  device=dev) for _ in range(2))
            if kind == "int8":
                kp, vp = tnn.kv_cache_quantize(kp), tnn.kv_cache_quantize(vp)
            pools[kind].append((kp, vp))
    paged_cases = [
        (kind, name, torch.tensor(lens, dtype=torch.int32, device=dev))
        for kind, name, lens in (
            ("int8", "lengths 1..2048",
             [1, 17, 256, 511, 1000, 1500, 2047, 2048]),
            ("int8", "mid-decode lengths", mid_decode_lengths()),
            ("float32", "lengths 1..2048",
             [1, 17, 256, 511, 1000, 1500, 2047, 2048]))]
    b, l = 8, 1024
    qkv = {dt: [torch.randn(b, heads, l, d, generator=g, device=dev).to(dt)
                for _ in range(3)] for dt in (torch.float32, torch.bfloat16)}
    # K5a at the decode step's shape, 12 weight sets (cold in L2)
    u = heads * d
    x5 = torch.randn(8, u, generator=g, device=dev)
    w5 = [(0.02 * torch.randn(3 * u, u, generator=g, device=dev),
           0.02 * torch.randn(3 * u, generator=g, device=dev))
          for _ in range(12)]
    # K5b at the decode step's shape, 12 weight sets (cold in L2)
    a5 = torch.randn(8, u, generator=g, device=dev)
    wo5 = [(0.02 * torch.randn(u, u, generator=g, device=dev),
            0.02 * torch.randn(u, generator=g, device=dev))
           for _ in range(12)]
    saved = dict(_build._libs)
    res = []
    try:
        for rep in range(2):
            for (name, label, _), lib, log in zip(trials, libs, logs):
                _build._libs[name] = lib
                row = {"source": name, "trial": label, "rep": rep,
                       "ptxas": log, "ms": {}}
                if name == "paged_attention":
                    for kind, case, lengths in paged_cases:
                        ps = pools[kind]
                        with torch.no_grad():
                            out = kpa.paged_attention_kernel(
                                q, ps[0][0], ps[0][1], table, lengths)
                            ref = kpa.paged_attention_plain(
                                q, ps[0][0], ps[0][1], table, lengths)
                        err = (out - ref).abs().max().item()
                        check(err <= 1e-4, f"trial {label}: err {err}")
                        row["ms"][f"{kind} {case}"] = time_ms(
                            lambda i: kpa.paged_attention_kernel(
                                q, ps[i][0], ps[i][1], table, lengths),
                            len(ps))[0]
                elif "K5b" in label:
                    geo = kfd.out_geometry(u, u, torch.float32)
                    if not label.startswith("diagnostic"):
                        with torch.no_grad():
                            err = (kfd.fused_out_project(a5, *wo5[0])
                                   - kfd.out_project_plain(a5, *wo5[0])
                                   ).abs().max().item()
                        check(err <= 1e-4, f"trial {label}: err {err}")
                    row["geometry"] = geo
                    row["ms"][f"N8 U{u} f32, {geo['route']} route, rows "
                              f"{geo['rows']}, stages {geo['stages']}, "
                              f"blocks {geo['blocks']}"] = time_ms(
                        lambda i: kfd.fused_out_project(a5, *wo5[i]),
                        len(wo5))[0]
                elif name == "fused_decode":
                    c = kfd.qkv_cluster(u, heads, torch.float32)
                    if not label.startswith("diagnostic"):
                        with torch.no_grad():
                            got = kfd.fused_qkv_project(
                                x5, *w5[0], heads=heads,
                                store_dtype=torch.int8)
                            want = kfd.qkv_project_plain(x5, *w5[0], heads,
                                                         torch.int8)
                        err = (got[0] - want[0]).abs().max().item()
                        check(err <= 1e-4, f"trial {label}: q err {err}")
                        int8_rows_diff(torch, got[1:], want[1:],
                                       f"trial {label}")
                    row["cluster"] = c
                    row["ms"][f"N8 U{u} int8, cluster {c}"] = time_ms(
                        lambda i: kfd.fused_qkv_project(
                            x5, *w5[i], heads=heads,
                            store_dtype=torch.int8), len(w5))[0]
                else:
                    for dt, (qq, kk, vv) in qkv.items():
                        with torch.no_grad():
                            out, _ = kfa.flash_forward(qq, kk, vv, True)
                            ref, _ = kfa.flash_forward_plain(qq, kk, vv,
                                                             True)
                        err = (out.float() - ref.float()).abs().max().item()
                        lim = FLASH_TOL[str(dt)[6:]] * max(
                            ref.float().abs().max().item(), 1.0)
                        check(err <= lim, f"trial {label} {dt}: {err}")
                        with torch.no_grad():
                            row["ms"][str(dt)[6:]] = time_ms(
                                lambda i: kfa.flash_forward(qq, kk, vv,
                                                            True))[0]
                print(f"trial {name} [{label}] run {rep + 1}: " + ", ".join(
                    f"{k} {v:.5f} ms" for k, v in row["ms"].items()),
                    flush=True)
                res.append(row)
    finally:
        _build._libs.clear()
        _build._libs.update(saved)
    if any("K5b" in t[1] for t in trials):
        res.append(k5b_landing(torch, res, a5, wo5))
    return res


def k5b_landing(torch, res, a5, wo5):
    """The rate at which K5b's slabs land: W_out's bytes over the time
    the diagnostic build without the products takes beyond the one that
    returns at entry (both ring route builds of the source), per run;
    beside it F.linear on the same inputs as a yardstick."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.kernels import fused_decode as kfd

    def times(label):
        return [next(iter(r["ms"].values())) for r in res
                if r["trial"] == f"diagnostic: K5b {label}"]

    u = a5.shape[1]
    geo = kfd.out_geometry(u, u, torch.float32)
    w_bytes = 4 * u * u
    x_bytes = 4 * 8 * u * geo["blocks"]      # every block's activations
    land = [b - a for a, b in zip(times("returning at entry"),
                                  times("without the products"))]
    lin = time_ms(lambda i: F.linear(a5, *wo5[i]), len(wo5))[0]
    out = {"trial": "K5b slab landing", "w_bytes": w_bytes,
           "x_bytes_from_l2": x_bytes, "landing_ms": land,
           "w_tb_s": [w_bytes / (1e9 * ms) for ms in land],
           "w_and_x_tb_s": [(w_bytes + x_bytes) / (1e9 * ms) for ms in land],
           "f_linear_ms": lin}
    print(f"K5b slab landing at N8 U{u} f32: no-products minus "
          f"return-at-entry {land} ms per run: W_out {w_bytes} bytes at "
          f"{out['w_tb_s']} TB/s (with every block's activations from L2, "
          f"{x_bytes} bytes more: {out['w_and_x_tb_s']} TB/s) against "
          f"3.35 TB/s; F.linear {lin:.5f} ms", flush=True)
    return out


# -- phase 14: the compiled training step ------------------------------------
# the reference runs a hybridized block under autograd.record() as a
# compiled forward and backward, and the Trainer's update as one program;
# here they are CUDA graphs. Each model trains GT_STEPS steps eager
# (inside _graphs_off()), eager again (are the kernels deterministic?) and
# graphed, from the same seed; then GT_TIMED more steps are timed in
# each mode. Where the two eager runs agree bitwise the graphed one must
# too; otherwise each parameter's change over the steps is held in norm
# to GT_NORM_TOL (phase 9's limit of the card against the CPU)
GT_STEPS, GT_TIMED, GT_PROFILED = 3, 10, 2
GT_NORM_TOL = RN_CPU_GRAD_TOL
GT_DROPOUT = 0.1
# BERT's losses with dropout 0.1, graphed against eager: other masks, the
# same distribution; each step's mean loss within 5% of eager's
GT_DROPOUT_TOL = 5e-2
# torch.func against autograd on the card: the same kernels in the same
# order (1e-5 of each gradient's norm); vmap's folded batch against
# per-slice calls: cuBLAS may take other algorithms at the folded shapes
# (1e-4 of the logits' largest magnitude)
GT_FUNC_TOL, GT_VMAP_TOL = 1e-5, 1e-4
# every fusable optimizer: its variants of the CPU tests
GT_OPTIMIZERS = [
    ("sgd", {"momentum": 0.9}), ("sgd", {}), ("nag", {}), ("signum", {}),
    ("signum", {"momentum": 0.0, "wd_lh": 0.01}),
    ("dcasgd", {"momentum": 0.9}), ("lars", {}), ("adam", {}),
    ("adam", {"correct_bias": False}), ("adamw", {}), ("adamax", {}),
    ("adagrad", {}), ("adadelta", {}), ("rmsprop", {}),
    ("rmsprop", {"centered": True, "clip_weights": 0.5}), ("ftrl", {}),
    ("ftml", {}), ("lamb", {}),
    ("lamb", {"bias_correction": False, "lower_bound": 0.5,
              "upper_bound": 2.0}),
    ("groupadagrad", {}), ("sgd", {"momentum": 0.9, "multi_precision": True})]
GT_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernelEx")


def gt_snapshot(net):
    return {n: p.data().detach().clone()
            for n, p in net.collect_params().items()}


def gt_compare(torch, init, a, b):
    """(bitwise-equal count, worst ||(b - init) - (a - init)|| / ||a -
    init|| over the tensors that moved)."""
    same, worst = 0, 0.0
    for n in a:
        same += int(torch.equal(a[n], b[n]))
        da = (a[n] - init[n]).float()
        nd = da.norm().item()
        if nd > 0:
            worst = max(worst, ((b[n] - init[n]).float() - da).norm().item()
                        / nd)
    return same, worst


def gt_profile(torch, step, steps=GT_PROFILED):
    """torch.profiler over ``steps`` steps: per step the kernel launches
    made outside graphs (runtime launch calls), graph launches, memcpy
    calls, device ms summed over every kernel and copy (a graph's
    kernels included) and the profiled wall ms."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    calls = Counter(e.name for e in prof.events()
                    if e.device_type == DeviceType.CPU)
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation) / 1e3 / steps
    return {"launches_outside_graphs": sum(calls[c] for c in
                                           GT_LAUNCH_CALLS) / steps,
            "graph_launches": calls["cudaGraphLaunch"] / steps,
            "memcpy_calls": sum(v for k, v in calls.items()
                                if k.startswith("cudaMemcpy")) / steps,
            "device_ms": dev_ms, "profiled_wall_ms": wall}


def gt_train(torch, card, wrappers, what, net, trainer_of, step_of, init,
             want_launches):
    """One model's three runs (eager, eager again, graphed) of GT_STEPS
    steps from ``init``, then GT_TIMED timed and GT_PROFILED profiled
    steps in each mode. ``trainer_of()`` makes a fresh Trainer,
    ``step_of(trainer)`` a step function returning the loss. Checks the
    weights (and BatchNorm statistics) after GT_STEPS steps, and in the
    graphed mode the launches of ``want_launches`` per replayed step."""
    from mxnet_tpu_torch.gluon.block import _graphs_off

    dev = next(iter(init.values())).device
    params = net.collect_params()
    runs, out = {}, {"card": card}
    for mode in ("eager", "eager again", "graphed"):
        for n, p in params.items():
            p.set_data(init[n])
        net.zero_grad(set_to_none=True)
        net.hybridize()
        trainer = trainer_of()
        step = step_of(trainer)
        cap0 = (net.captures, trainer.captures)
        with _graphs_off() if mode != "graphed" else nullcontext():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            losses = [step().mean().item() for _ in range(GT_STEPS)]
            runs[mode] = gt_snapshot(net)
            if mode == "eager again":
                continue
            for w in wrappers.values():
                w.launches = 0
            ms = []
            for _ in range(GT_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            counts = {k: w.launches for k, w in wrappers.items()}
            prof = gt_profile(torch, step)
        peak = torch.cuda.max_memory_allocated(dev)
        # the profiler slows the host: the busy share is the profiled
        # device ms over the unprofiled median step
        prof["device_busy"] = prof["device_ms"] / float(np.median(ms))
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{what} {mode}: loss did not fall {losses}")
        per_step = {k: v / GT_TIMED for k, v in counts.items() if v}
        if mode == "graphed":
            want = {k: v for k, v in want_launches.items() if v}
            check(per_step == want, f"{what} graphed: launches per replayed "
                  f"step {per_step} != {want}")
            check(net.captures == cap0[0] + 1
                  and trainer.captures == cap0[1] + 1,
                  f"{what}: {net.captures - cap0[0]} block captures, "
                  f"{trainer.captures - cap0[1]} update captures")
        out[mode] = {
            "losses": losses, "step_ms": ms,
            "step_ms_median": float(np.median(ms)),
            "step_ms_range": [min(ms), max(ms)], "launches_per_step":
            per_step, "profile": prof, "max_memory_allocated": peak,
            "captures": net.captures + trainer.captures,
            "capture_s": net.capture_s + trainer.capture_s}
        print(f"{what} on {card}, {mode}: loss {[round(v, 5) for v in losses]}"
              f"; step ms over {GT_TIMED} steps median "
              f"{out[mode]['step_ms_median']:.3f} range "
              f"{min(ms):.3f}-{max(ms):.3f}; device ms "
              f"{prof['device_ms']:.3f}, busy {prof['device_busy']:.3f}; "
              f"kernel launches outside graphs per step "
              f"{prof['launches_outside_graphs']:.1f}, graph launches "
              f"{prof['graph_launches']:.1f}, memcpy calls "
              f"{prof['memcpy_calls']:.1f}; port kernels per step "
              f"{per_step}; captures {out[mode]['captures']} in "
              f"{out[mode]['capture_s']:.3f} s; max_memory_allocated "
              f"{peak / 2**30:.3f} GiB", flush=True)
    det_same, det_worst = gt_compare(torch, init, runs["eager"],
                                     runs["eager again"])
    same, worst = gt_compare(torch, init, runs["eager"], runs["graphed"])
    n = len(runs["eager"])
    deterministic = det_same == n
    if deterministic:
        check(same == n, f"{what}: the kernels are deterministic (two eager "
              f"runs bitwise equal) but graphed differs in {n - same} of "
              f"{n} tensors")
    check(worst <= GT_NORM_TOL, f"{what}: graphed against eager {worst} > "
          f"{GT_NORM_TOL}")
    out["against_eager"] = {"tensors": n, "bitwise": same,
                            "worst_rel_norm": worst,
                            "eager_deterministic": deterministic,
                            "eager_vs_eager_worst": det_worst}
    print(f"{what}: after {GT_STEPS} steps graphed against eager: {same} of "
          f"{n} tensors bitwise equal, worst change error in norm "
          f"{worst:.3e} (limit {GT_NORM_TOL:g}); two eager runs: {det_same} "
          f"bitwise equal ({'deterministic: bitwise required' if deterministic else 'nondeterministic kernels: held in norm'}"
          f", worst {det_worst:.3e})", flush=True)
    return out


def gt_resnet(torch, card, wrappers):
    """example/gluon/image_classification.py's loop on ResNet-50 v1 (B 32,
    224x224, default policy): ``hybridize()``, ``autograd.record()``,
    SoftmaxCrossEntropyLoss, ``Trainer("nag")`` with phase 11's
    momentum, wd and MultiFactorScheduler; the shapes completed by
    ``infer_shape``; K3 once a step and nothing else of the port."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.optimizer.lr_scheduler import MultiFactorScheduler

    dev = mx.context.resolve_device(None)
    net = vision.get_model("resnet50_v1", classes=RN_CLASSES)
    net.initialize()
    rng = np.random.default_rng(SEED + 14)
    x = torch.from_numpy(rng.random((RN_B, 3, RN_HW, RN_HW),
                                    dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, RN_CLASSES, RN_B)).to(dev)
    shape = net.infer_shape(x)
    check(shape == (RN_B, RN_CLASSES)
          and all(p.initialized for p in net.collect_params().values()),
          f"infer_shape: {shape}")
    from_jax_params(resnet_weights(net, SEED), net)
    init = gt_snapshot(net)
    loss_fn = SoftmaxCrossEntropyLoss()

    def trainer_of():
        return Trainer(net.collect_params(), "nag", dict(
            FRONT_NAG, lr_scheduler=MultiFactorScheduler(**FRONT_SCHEDULE)))

    def step_of(trainer):
        def step():
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(RN_B)
            return loss.detach()
        return step

    want = dict({k: 0 for k in wrappers}, cross_entropy_lse=1)
    with matmul_precision_scope("default"):
        out = gt_train(torch, card, wrappers, "resnet50_v1 B32 224x224 NAG",
                       net, trainer_of, step_of, init, want)
    out["infer_shape"] = list(shape)
    return out


def gt_bert(torch, card, wrappers):
    """BERT-base pretraining at train_bench.py's settings (B 32, L 128,
    the MLM loss, SGD momentum 0.9, lr 0.05) hybridized, default policy:
    with dropout 0.0 the three runs of :func:`gt_train` and K1 forward,
    K1c and K1d 12 each, K2 26 and K3 once per replayed step; with
    dropout GT_DROPOUT, two replays of the recorded forward draw other
    masks (no new capture), and GT_STEPS graphed steps' losses follow
    eager's within GT_DROPOUT_TOL."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.block import _graphs_off
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import (BERTForPretraining,
                                                      bert_base)

    dev = mx.context.resolve_device(None)
    mx.np.random.seed(SEED)
    net = BERTForPretraining(bert_base(dropout=0.0))
    net.initialize()
    init = gt_snapshot(net)
    tokens, types, _ = bert_batch(torch, dev)
    loss_fn = SoftmaxCrossEntropyLoss()

    def trainer_of(model=net):
        return Trainer(model.collect_params(), "sgd",
                       {"learning_rate": 0.05, "momentum": 0.9})

    def step_of(trainer, model=net):
        def step():
            with autograd.record():
                mlm, _ = model(tokens, types)
                loss = loss_fn(mlm, tokens)
            autograd.backward(loss)
            # eager leaves the NSP head and the pooler without a gradient
            # (the graph gives them zeros, which move nothing)
            trainer.step(BERT_B, ignore_stale_grad=True)
            return loss.detach()
        return step

    with matmul_precision_scope("default"):
        out = gt_train(torch, card, wrappers, "BERT-base B32 L128 SGD", net,
                       trainer_of, step_of, init, BERT_TRAIN_LAUNCHES)
        out["torch_func"] = gt_torch_func(torch, net, tokens, types,
                                          wrappers)
        out["accumulate"] = gt_accumulate(torch, card, net, init, tokens,
                                          types, loss_fn, trainer_of)
        del net
        torch.cuda.empty_cache()
        drop = BERTForPretraining(bert_base(dropout=GT_DROPOUT))
        drop.initialize()
        for n, p in drop.collect_params().items():
            p.set_data(init[n])
        drop.hybridize()
        # two recorded calls on the same weights: other masks
        cap = drop.captures
        outs = []
        for _ in range(3):
            with autograd.record():
                mlm, _ = drop(tokens, types)
                loss = loss_fn(mlm, tokens)
            autograd.backward(loss)
            outs.append(mlm.detach())
        drop.zero_grad(set_to_none=True)
        check(drop.captures == cap + 1 and drop.replays == 3,
              f"dropout calls: {drop.captures - cap} captures, "
              f"{drop.replays} replays")
        check(not torch.equal(outs[1], outs[2])
              and not torch.equal(outs[0], outs[1]),
              "two replays of the dropout forward drew the same masks")
        losses = {}
        for mode in ("eager", "graphed"):
            for n, p in drop.collect_params().items():
                p.set_data(init[n])
            drop.hybridize()
            step = step_of(trainer_of(drop), drop)
            with _graphs_off() if mode == "eager" else nullcontext():
                losses[mode] = [step().mean().item()
                                for _ in range(GT_STEPS)]
        rel = max(abs(a - b) / abs(a) for a, b in zip(losses["eager"],
                                                      losses["graphed"]))
        check(all(l[-1] < l[0] for l in losses.values())
              and rel <= GT_DROPOUT_TOL,
              f"dropout {GT_DROPOUT}: losses {losses} (rel {rel})")
    out["dropout"] = {"rate": GT_DROPOUT, "losses": losses, "worst_rel": rel}
    print(f"BERT-base with dropout {GT_DROPOUT} on {card}: two replays of the "
          f"recorded forward draw other masks (no new capture); loss over "
          f"{GT_STEPS} steps eager {[round(v, 5) for v in losses['eager']]}, "
          f"graphed {[round(v, 5) for v in losses['graphed']]} (worst "
          f"{rel:.3e} apart, limit {GT_DROPOUT_TOL:g})", flush=True)
    return out


def gt_accumulate(torch, card, net, init, tokens, types, loss_fn,
                  trainer_of):
    """BERT-base with every parameter's ``grad_req`` "add": two recorded
    micro-batches of BERT_B // 2 (one key, so the second call's forward
    replays the graph pair whose backward wrote the first call's
    gradients, which ``.grad`` still holds), then one Trainer step;
    eager against graphed, the summed gradients and the weights after
    the step bitwise."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.block import _graphs_off

    params = net.collect_params()
    half = BERT_B // 2
    got = {}
    for mode in ("eager", "graphed"):
        for n, p in params.items():
            p.set_data(init[n])
            p.grad_req = "add"
        net.zero_grad(set_to_none=True)
        net.hybridize()
        trainer = trainer_of()
        with _graphs_off() if mode == "eager" else nullcontext():
            for k in range(2):
                t = tokens[k * half:(k + 1) * half]
                with autograd.record():
                    mlm, _ = net(t, types[k * half:(k + 1) * half])
                    loss = loss_fn(mlm, t)
                autograd.backward(loss)
            grads = {n: p.data().grad.clone()
                     for n, p in params.items()
                     if p.data().grad is not None}
            trainer.step(BERT_B, ignore_stale_grad=True)
        got[mode] = (grads, gt_snapshot(net), net.captures)
    for p in params.values():
        p.grad_req = "write"
    net.zero_grad(set_to_none=True)
    (ge, we, _), (gg, wg, captures) = got["eager"], got["graphed"]
    # eager leaves the NSP head and the pooler without a gradient, the
    # graph gives them zeros
    grads_same = sum(int(torch.equal(ge[n], gg[n])) for n in ge)
    extra = [n for n in gg if n not in ge and bool(gg[n].any())]
    weights_same = sum(int(torch.equal(we[n], wg[n])) for n in we)
    check(grads_same == len(ge) and not extra and weights_same == len(we)
          and captures == 1,
          f"grad_req='add' over two micro-batches: {grads_same} of "
          f"{len(ge)} gradients and {weights_same} of {len(we)} weights "
          f"bitwise eager's, nonzero where eager has none {extra[:3]}, "
          f"{captures} captures")
    print(f"BERT-base grad_req='add' on {card}: two recorded micro-batches "
          f"of {half} (one graph pair) then one step: {grads_same} of "
          f"{len(ge)} summed gradients and {weights_same} of {len(we)} "
          f"weights bitwise equal to eager", flush=True)
    return {"gradients": len(ge), "gradients_bitwise": grads_same,
            "weights": len(we), "weights_bitwise": weights_same}


def gt_torch_func(torch, net, tokens, types, wrappers):
    """``torch.func.grad`` of the MLM loss over BERT's ``functionalize``
    fn on the card against autograd's gradients through the same fn (K1
    forward, K1c, K1d 12 each), and ``torch.func.vmap`` of fn over a
    leading axis of 2 batches of 4 against per-batch calls."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    loss_fn = SoftmaxCrossEntropyLoss()
    fn, params = net.functionalize(tokens, types)

    def loss(p):
        return loss_fn(fn(p, tokens, types)[0][0], tokens).mean()

    for w in wrappers.values():
        w.launches = 0
    got = torch.func.grad(loss)(params)
    counts = {k: w.launches for k, w in wrappers.items() if w.launches}
    given = {n: t.clone().requires_grad_() for n, t in params.items()}
    # the NSP head and the pooler take no part in the MLM loss:
    # torch.func.grad gives them zeros, autograd None
    want = {n: torch.zeros_like(given[n]) if g is None else g
            for n, g in zip(given, torch.autograd.grad(
                loss(given), list(given.values()), allow_unused=True))}
    worst = max((got[n] - want[n]).norm().item()
                / max(want[n].norm().item(), 1e-30) for n in want)
    check(worst <= GT_FUNC_TOL, f"torch.func.grad vs autograd {worst}")
    check(counts.get("flash_attention_fwd") == 12
          and counts.get("flash_attention_bwd_dq") == 12
          and counts.get("flash_attention_bwd_dkv") == 12,
          f"torch.func.grad launches {counts}")
    t4, y4 = tokens[:8].reshape(2, 4, -1), types[:8].reshape(2, 4, -1)
    mapped = torch.func.vmap(lambda t, y: fn(params, t, y)[0][0])(t4, y4)
    each = torch.stack([fn(params, t, y)[0][0] for t, y in zip(t4, y4)])
    verr = ((mapped - each).abs().max() / each.abs().max()).item()
    check(verr <= GT_VMAP_TOL, f"torch.func.vmap vs per-batch {verr}")
    print(f"torch.func on the card: grad of BERT's functionalize fn against "
          f"autograd, worst {worst:.3e} of a gradient's norm (limit "
          f"{GT_FUNC_TOL:g}), launches {counts}; vmap over 2 x B4 against "
          f"per-batch calls {verr:.3e} of the largest logit (limit "
          f"{GT_VMAP_TOL:g})", flush=True)
    return {"grad_worst": worst, "grad_launches": counts, "vmap_err": verr}


def gt_optimizers(torch, card):
    """Each of GT_OPTIMIZERS in two Trainers over gpt_like's (32000, 768)
    embedding and a (768,) bias (bfloat16 with float32 masters for the
    multi-precision SGD; GroupAdaGrad the embedding alone), 3 steps from
    one set of seeded weights and gradients under a FactorScheduler that
    halves the rate each step (wd 1e-2 but GroupAdaGrad's 0, clip 1.0):
    the graphed Trainer's update (step 1 eager and captured, 2 and 3
    replayed) bitwise equal to the eager one's (inside _graphs_off), the
    weights and every state tensor."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.block import _graphs_off
    from mxnet_tpu_torch.gluon.parameter import Parameter
    from mxnet_tpu_torch.optimizer.lr_scheduler import FactorScheduler

    rng = np.random.default_rng(SEED + 141)
    shapes = [(CFG["vocab_size"], CFG["units"]), (CFG["units"],)]
    weights = [rng.standard_normal(s, dtype=np.float32) * np.float32(0.02)
               for s in shapes]
    grads = [[rng.standard_normal(s, dtype=np.float32) for s in shapes]
             for _ in range(3)]
    dev = torch.device("cuda", 0)
    rows = []
    for name, kw in GT_OPTIMIZERS:
        n = 1 if name == "groupadagrad" else 2
        half = kw.get("multi_precision", False)
        kw = dict(kw, clip_gradient=1.0, learning_rate=0.1,
                  wd=0.0 if name == "groupadagrad" else 1e-2)
        runs = []
        for graphed in (True, False):
            ps = []
            for i, w in enumerate(weights[:n]):
                p = Parameter(f"p{i}", shape=w.shape)
                p.set_data(torch.from_numpy(w), device=dev)
                if half:
                    p.cast("bfloat16")
                ps.append(p)
            tr = Trainer(ps, name, dict(kw, lr_scheduler=FactorScheduler(
                step=1, factor=0.5, base_lr=0.1)))
            with nullcontext() if graphed else _graphs_off():
                for g in grads:
                    for p, gk in zip(ps, g):
                        p.data().grad = torch.from_numpy(gk).to(
                            dev, p.data().dtype)
                    tr.step(1)
            runs.append((tr, [p.data().detach() for p in ps]))
        (tg, wg), (te, we) = runs
        same = all(torch.equal(a, b) for a, b in zip(wg, we)) and all(
            states_equal(torch, tg._states[i], te._states[i])
            for i in te._states)
        check(same, f"{name} {kw}: graphed update differs from eager")
        check(tg.captures == 1 and tg.replays == 2 and te.captures == 0,
              f"{name}: captures {tg.captures} replays {tg.replays}")
        rows.append(name + "".join(f" {k}={v}" for k, v in kw.items()
                                   if k not in ("clip_gradient", "wd",
                                                "learning_rate")))
    print(f"every fusable optimizer on {card}: the Trainer's captured update "
          f"(one graph a step, lr, rescale_grad and t as device scalars) "
          f"bitwise equal to its eager update over 3 steps with the rate "
          f"halving each step: {rows}", flush=True)
    return rows


def gt_node_semantics(torch, card):
    """The recorded node's gradient semantics on the card, a small MLP
    (Dense 256 relu, Dense 10) eager against graphed, bitwise: a
    ``grad_req="add"`` weight summing two backwards, an input's
    gradient (its call is a key of its own), and two calls of another
    key before their backwards (the second takes its own graph pair,
    dropped after its backward: 3 pairs captured, 2 kept, each key's
    first reused by the next calls)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    dev = torch.device("cuda", 0)
    net = nn.HybridSequential()
    net.add(nn.Dense(256, activation="relu", in_units=64), nn.Dense(10))
    net.initialize(device=dev)
    net[0].weight.grad_req = "add"
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 142)
    xs = [torch.randn(32, 64, generator=g, device=dev) for _ in range(2)]
    got = []
    for active in (False, True):
        net.hybridize(active)
        net.zero_grad(set_to_none=True)
        xin = xs[0].clone().requires_grad_()
        with autograd.record():
            a = net(xin).square().sum()
            b = net(xs[1]).square().sum()
            b2 = net(xs[0]).square().sum()
        autograd.backward([a, b, b2])
        with autograd.record():
            c = net(xin).square().sum()
            d = net(xs[1]).square().sum()
        autograd.backward([c, d])
        got.append(({n: p.grad().clone() for n, p in
                     net.collect_params().items()}, xin.grad.clone()))
    (ge, xe), (gg, xg) = got
    check(all(torch.equal(ge[n], gg[n]) for n in ge) and torch.equal(xe, xg),
          "the recorded node's gradients differ from eager")
    pairs = sum(len(v) for v in net._train_graphs.values())
    check(net.captures == 3 and pairs == 2,
          f"two pending calls of a key: {net.captures} captures, {pairs} "
          "pairs kept")
    print(f"recorded node on {card}: a grad_req='add' weight over two "
          "backwards, an input's gradient and two calls of a key pending "
          "at once (3 graph pairs captured, the extra one dropped after "
          "its backward) bitwise equal to eager", flush=True)
    return {"captures": net.captures}


def graphtrain_phase(torch, card, wrappers):
    """Phase 14: the compiled training step (:func:`gt_optimizers`,
    :func:`gt_node_semantics`, :func:`gt_resnet`, :func:`gt_bert` with
    :func:`gt_torch_func` and :func:`gt_accumulate`)."""
    t_phase = time.perf_counter()
    out = {"optimizers": gt_optimizers(torch, card),
           "node": gt_node_semantics(torch, card)}
    torch.cuda.empty_cache()
    out["resnet"] = gt_resnet(torch, card, wrappers)
    torch.cuda.empty_cache()
    out["bert"] = gt_bert(torch, card, wrappers)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14 took {out['seconds']:.1f} s on {card}", flush=True)
    return out


# -- phase 15: the array layer -------------------------------------------------
# Every function this PR ports (``mx.np`` with ``linalg``, ``fft`` and
# ``random``, and ``mx.npx`` with its ``random``) runs on cuda:0 at
# gpt_like's and BERT-base's widths, from numpy seed 0, and is held
# against the same call on a CPU copy at the CPU tests' tolerances
# (tests/test_torch_np_surface.py, tests/test_torch_npx_ops.py): exact for
# integer, bool, index, sort and set results, 1e-5 (of the result's
# largest magnitude, plus that relative) for float elementwise results,
# 1e-4 for reductions, products and linear algebra; decompositions by
# their invariants. Samplers draw 2**24 values each and are held on their
# moments (threefry and Philox never agree; a CPU draw is another
# stream): mean and variance within ARRAY_MOMENT_TOL of the
# distribution's, relative, plus six standard errors of the mean.
ARRAY_ROWS, ARRAY_UNITS = 8192, 768          # gpt_like activations
ARRAY_TOKENS = (8, 1024)                     # token ids in [0, 32000)
ARRAY_VOCAB = 32000
ARRAY_MATS = (64, 256, 256)                  # batched matrices
ARRAY_FFT = (8, 1024, 768)                   # fft along the last axis
ARRAY_DRAWS = 1 << 24
ARRAY_EW, ARRAY_RED = 1e-5, 1e-4
ARRAY_MOMENT_TOL = 0.01
# qr, svd, eigh, eig and eigvals at side 256 in f32: the CPU tests' 1e-3
# for decompositions (their reconstructions and |factors|); the f32
# solvers' backward error is a small multiple of 256 * 2**-24 of the
# matrix's norm, and the reconstructions are taken in f64
ARRAY_DECOMP_TOL = 1e-3
# the CPU copy of the batched linear algebra holds its first matrices
# (each matrix's result depends on that matrix alone), and the CPU copy
# of the elementwise family its first rows (each value depends on its
# own row alone)
ARRAY_CPU_MATS = 8
ARRAY_CPU_ROWS = 1024
# callables of the swept modules that phase 15 does not sweep: names of
# earlier slices (run by phases 2-14), of phase 16 (ops/contrib.py's and
# control flow's npx names), imports, and numpy's type classes
ARRAY_EARLIER = {
    "numpy": """abs absolute add arange arccos arccosh arcsin arcsinh arctan
        arctan2 arctanh argmax argmin around array asarray cbrt ceil
        concatenate copysign cos cosh deg2rad degrees divide dot empty
        empty_like equal erf erfinv exp exp2 expand_dims expm1 fabs fix
        floor floor_divide fmax fmin fmod full full_like greater
        greater_equal hypot isfinite isinf isnan less less_equal linspace
        log log10 log1p log2 logaddexp logical_and logical_not logical_or
        logical_xor matmul max maximum mean min minimum mod multiply
        negative not_equal ones ones_like positive pow power rad2deg radians
        reciprocal relu remainder reshape rint round sigmoid sign sin sinh
        sqrt square squeeze stack subtract sum tan tanh transpose
        true_divide trunc zeros zeros_like""",
    "numpy.random": "normal randint seed uniform",
    "numpy_extension": """activation batch_norm convolution deconvolution
        dropout embedding fully_connected gelu group_norm instance_norm
        l2_normalization layer_norm leaky_relu pooling rms_norm
        all_finite allclose bilinear_resize_2d bipartite_matching box_iou
        box_nms count_sketch deformable_convolution gradientmultiplier
        hawkes_ll index_array khatri_rao modulated_deformable_convolution
        multi_all_finite multi_sum_sq multibox_detection multibox_prior
        multibox_target nnz psroi_pooling quadratic roi_align roi_pooling
        round_ste sign_ste sync_batch_norm foreach while_loop cond""",
    "numpy_extension.random": "normal randint seed uniform",
}
ARRAY_NOT_API = {
    "numpy": """MXNetError asnumpy current_context drop_index dtype_from_any
        from_numpy resolve_device ndarray floating integer
        signedinteger unsignedinteger inexact complexfloating number generic
        character flexible object_ ufunc""",
    "numpy.linalg": "",
    "numpy.fft": "",
    "numpy.random": "dtype_from_any generator resolve_device",
    "numpy_extension": "MXNetError is_training",
    "numpy_extension.random": "MXNetError dtype_from_any generator",
}


def array_inputs(torch, dev):
    """The sweep's inputs from numpy seed 0, on ``dev``."""
    rng = np.random.RandomState(SEED)
    n, u = ARRAY_ROWS, ARRAY_UNITS
    b, m, _ = ARRAY_MATS
    host = {
        "A": rng.randn(n, u).astype(np.float32),
        "B": rng.randn(n, u).astype(np.float32),
        "P": (rng.rand(n, u) + 0.5).astype(np.float32),
        "U": (rng.rand(n, u) * 1.8 - 0.9).astype(np.float32),
        "I": rng.randint(-1000, 1000, (n, u)).astype(np.int64),
        "IS": rng.randint(-25, 26, (n, u)).astype(np.int64),
        "J": rng.randint(1, 1000, (n, u)).astype(np.int64),
        "TOK": rng.randint(0, ARRAY_VOCAB, ARRAY_TOKENS).astype(np.int64),
        "LOG": rng.randn(8, ARRAY_VOCAB).astype(np.float32),
        "V": rng.randn(u).astype(np.float32),
        "S": np.sort(rng.randn(4096)).astype(np.float32),
        "C3": rng.randn(n, 3).astype(np.float32),
        "D3": rng.randn(n, 3).astype(np.float32),
        # well conditioned: the identity plus a small random part
        "MAT": (np.eye(m) + rng.randn(b, m, m) * (0.2 / np.sqrt(m))
                ).astype(np.float32),
        "RHS": rng.randn(b, m, 8).astype(np.float32),
        "RECT": rng.randn(b, m, 64).astype(np.float32),
        "FX": rng.randn(*ARRAY_FFT).astype(np.float32),
        # the interleaved products at BERT-base's (L 128, B 32, H 12, D 64)
        "QKV": rng.randn(128, 32, 3 * 768).astype(np.float32),
        "KV": rng.randn(128, 32, 2 * 768).astype(np.float32),
        "ATT": rng.rand(32 * 12, 128, 128).astype(np.float32),
        "POLY": np.array([1.0, -6.0, 11.0, -6.0], np.float32),
        "XS": np.linspace(0.0, 1.0, 4096).astype(np.float32),
    }
    host["B2"] = host["MAT"] @ np.swapaxes(host["MAT"], 1, 2)   # SPD
    host["NAN"] = host["A"].copy()
    host["NAN"][::7, ::5] = np.nan
    host["YS"] = (1 + 2 * host["XS"] - 3 * host["XS"] ** 2).astype(
        np.float32)
    out = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    out["AB"] = out["A"] > 0
    out["I32"] = out["I"].to(torch.int32)
    return out


def array_cases(torch, mx):
    """(family, module, name, fn, kind): ``fn(d, dev)`` calls ``name`` on
    the inputs ``d`` (on ``dev``); kind is the tolerance ("exact", "ew",
    "red"), or "mats" (linear algebra, held on the first matrices) or a
    callable check of its own."""
    np_, la, ff, npx = mx.np, mx.np.linalg, mx.np.fft, mx.npx
    nn_ = mx.ops.nn
    cases = []

    def add(family, mod, name, fn, kind="ew"):
        cases.append((family, mod, name, fn, kind))

    # creation
    for name, args in [("eye", (768,)), ("identity", (768,)),
                       ("tri", (768, 1024, -1)), ("logspace", (0, 3, 4096)),
                       ("geomspace", (1, 1000, 4096)),
                       ("indices", ((64, 128),)), ("bartlett", (4096,)),
                       ("blackman", (4096,)), ("hamming", (4096,)),
                       ("hanning", (4096,)), ("kaiser", (4096, 8.0)),
                       ("tril_indices", (768,)), ("triu_indices", (768, 1)),
                       ("diag_indices", (768,))]:
        add("creation", "numpy", name,
            lambda d, dev, n=name, a=args: getattr(np_, n)(*a, device=dev))
    add("creation", "numpy", "fromfunction", lambda d, dev: np_.fromfunction(
        lambda i, j: i * 768 + j, (64, 768), device=dev))
    add("creation", "numpy", "frombuffer", lambda d, dev: np_.frombuffer(
        np.arange(768, dtype=np.float32).tobytes(), device=dev), "exact")
    add("creation", "numpy", "fromiter", lambda d, dev: np_.fromiter(
        range(768), "int64", device=dev), "exact")
    add("creation", "numpy", "fromstring", lambda d, dev: np_.fromstring(
        "1 2 3 4", device=dev), "exact")
    add("creation", "numpy", "copy", lambda d, dev: np_.copy(d["A"]), "exact")
    add("creation", "numpy", "ascontiguousarray",
        lambda d, dev: np_.ascontiguousarray(d["A"].T), "exact")
    add("creation", "numpy", "astype", lambda d, dev: np_.astype(d["A"],
                                                                 "int32"),
        "exact")
    add("creation", "numpy", "from_dlpack", lambda d, dev: np_.from_dlpack(
        d["A"]), "exact")
    add("creation", "numpy", "meshgrid", lambda d, dev: np_.meshgrid(
        d["V"], d["S"]), "exact")
    add("creation", "numpy", "diag", lambda d, dev: np_.diag(d["V"]), "exact")
    add("creation", "numpy", "diagflat", lambda d, dev: np_.diagflat(
        d["V"][:256]), "exact")
    add("creation", "numpy", "diagonal", lambda d, dev: np_.diagonal(
        d["MAT"], 0, 1, 2), "exact")
    add("creation", "numpy", "tril", lambda d, dev: np_.tril(d["A"]), "exact")
    add("creation", "numpy", "triu", lambda d, dev: np_.triu(d["A"], 1),
        "exact")
    # shapes, joining, splitting, editing
    for name, f in [
            ("swapaxes", lambda d: np_.swapaxes(d["A"], 0, 1)),
            ("moveaxis", lambda d: np_.moveaxis(d["FX"], 0, -1)),
            ("rollaxis", lambda d: np_.rollaxis(d["FX"], 2)),
            ("ravel", lambda d: np_.ravel(d["A"])),
            ("flatten", lambda d: np_.flatten(d["I"])),
            ("permute_dims", lambda d: np_.permute_dims(d["FX"], (2, 0, 1))),
            ("matrix_transpose", lambda d: np_.matrix_transpose(d["MAT"])),
            ("broadcast_to", lambda d: np_.broadcast_to(d["V"], (64, 768))),
            ("broadcast_arrays", lambda d: np_.broadcast_arrays(
                d["V"], d["A"][:64, :1])),
            ("atleast_1d", lambda d: np_.atleast_1d(d["A"][0, 0])),
            ("atleast_2d", lambda d: np_.atleast_2d(d["V"])),
            ("atleast_3d", lambda d: np_.atleast_3d(d["A"])),
            ("concat", lambda d: np_.concat([d["A"], d["B"]], axis=1)),
            ("vstack", lambda d: np_.vstack([d["A"], d["B"]])),
            ("row_stack", lambda d: np_.row_stack([d["V"], d["V"]])),
            ("hstack", lambda d: np_.hstack([d["A"], d["I"]])),
            ("dstack", lambda d: np_.dstack([d["A"], d["B"]])),
            ("column_stack", lambda d: np_.column_stack([d["V"], d["V"]])),
            ("block", lambda d: np_.block([[d["A"], d["B"]]])),
            ("append", lambda d: np_.append(d["A"], d["B"], 0)),
            ("split", lambda d: np_.split(d["A"], 8)),
            ("array_split", lambda d: np_.array_split(d["A"], 5, axis=1)),
            ("hsplit", lambda d: np_.hsplit(d["A"], [100, 500])),
            ("vsplit", lambda d: np_.vsplit(d["A"], 4)),
            ("dsplit", lambda d: np_.dsplit(d["FX"], 2)),
            ("tile", lambda d: np_.tile(d["V"], (64, 2))),
            ("repeat", lambda d: np_.repeat(d["I"], 2, axis=0)),
            ("flip", lambda d: np_.flip(d["A"])),
            ("fliplr", lambda d: np_.fliplr(d["A"])),
            ("flipud", lambda d: np_.flipud(d["I"])),
            ("roll", lambda d: np_.roll(d["A"], 3, 1)),
            ("rot90", lambda d: np_.rot90(d["A"])),
            ("pad", lambda d: np_.pad(d["A"], ((1, 2), (3, 4)),
                                      mode="reflect")),
            ("resize", lambda d: np_.resize(d["V"], (100, 100))),
            ("insert", lambda d: np_.insert(d["A"], 5, 0.0, axis=0)),
            ("delete", lambda d: np_.delete(d["A"], [0, 7, 9], axis=1)),
            ("trim_zeros", lambda d: np_.trim_zeros(np_.pad(
                d["J"][0], (5, 7)))),
            ("fill_diagonal", lambda d: np_.fill_diagonal(d["A"][:768],
                                                          2.0))]:
        add("shapes", "numpy", name, lambda d, dev, f=f: f(d), "exact")
    # elementwise, float32 and int64 at (8192, 768)
    fl = ["logaddexp2", "float_power", "heaviside", "nextafter"]
    for name in fl:
        add("elementwise", "numpy", name, lambda d, dev, n=name: getattr(
            np_, n)(d["P"] if n == "float_power" else d["A"], d["B"]))
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm"):
        add("elementwise", "numpy", name, lambda d, dev, n=name: getattr(
            np_, n)(d["I"], d["J"]), "exact")
    for name in ("left_shift", "right_shift", "bitwise_left_shift",
                 "bitwise_right_shift"):
        add("elementwise", "numpy", name, lambda d, dev, n=name: getattr(
            np_, n)(d["J"], 3), "exact")
    for name in ("invert", "bitwise_not", "bitwise_invert"):
        add("elementwise", "numpy", name, lambda d, dev, n=name: getattr(
            np_, n)(d["I"]), "exact")
    add("elementwise", "numpy", "ldexp", lambda d, dev: np_.ldexp(
        d["A"], d["I32"] % 7))
    add("elementwise", "numpy", "divmod", lambda d, dev: np_.divmod(
        d["I"], d["J"]), "exact")
    add("elementwise", "numpy", "modf", lambda d, dev: np_.modf(d["A"] * 9))
    add("elementwise", "numpy", "frexp", lambda d, dev: np_.frexp(d["A"]),
        "exact")
    for name in ("sinc", "i0", "spacing", "signbit", "isposinf", "isneginf",
                 "real", "imag", "conj", "conjugate", "angle", "iscomplex",
                 "isreal", "nan_to_num", "gamma_fn", "gammaln", "acos",
                 "asin", "atan", "asinh", "atanh", "round_"):
        for key in ("U", "IS"):
            add("elementwise", "numpy", name, lambda d, dev, n=name, k=key:
                getattr(np_, n)(d[k]), "exact" if name in (
                    "signbit", "isposinf", "isneginf", "iscomplex", "isreal")
                else "ew")
    add("elementwise", "numpy", "acosh", lambda d, dev: np_.acosh(d["P"] + 1))
    add("elementwise", "numpy", "atan2", lambda d, dev: np_.atan2(d["A"],
                                                                  d["B"]))
    # phases given (not summed on each device, where a rounding apart
    # could move a step across the discontinuity)
    add("elementwise", "numpy", "unwrap", lambda d, dev: np_.unwrap(
        d["U"] * 4.0), "red")
    add("elementwise", "numpy", "isclose", lambda d, dev: np_.isclose(
        d["A"], d["A"] + 1e-6 * d["B"]), "exact")
    add("elementwise", "numpy", "clip", lambda d, dev: np_.clip(d["A"], -0.5,
                                                                0.5))
    # reductions and statistics
    for key in ("A", "I"):
        for name, kw in [("prod", dict(axis=1)), ("nansum", {}),
                         ("nanprod", dict(axis=0)), ("std", dict(axis=0)),
                         ("var", dict(axis=1, ddof=1)), ("median", {}),
                         ("percentile", dict(q=[10, 50, 90], axis=1)),
                         ("quantile", dict(q=0.3, axis=0)),
                         ("average", dict(axis=0)), ("ptp", dict(axis=1)),
                         ("cumsum", dict(axis=1)), ("cumprod", dict(axis=1)),
                         ("count_nonzero", dict(axis=0)), ("all", {}),
                         ("any", dict(axis=1)), ("amax", dict(axis=0)),
                         ("amin", {}), ("diff", dict(axis=1)),
                         ("ediff1d", {}), ("trapz", {}),
                         ("trapezoid", dict(axis=0)), ("nanargmax", {}),
                         ("nanargmin", dict(axis=1)),
                         ("nancumsum", dict(axis=0)),
                         ("nancumprod", dict(axis=1))]:
            if key == "A" and name == "cumprod":
                continue              # f32 products of 768 normals
            add("reductions", "numpy", name, lambda d, dev, n=name, k=key,
                kw=kw: getattr(np_, n)(d[k] if n != "cumprod" else d[k] % 3,
                                       **kw), "red")
    add("reductions", "numpy", "cumsum", lambda d, dev: np_.cumsum(d["TOK"]),
        "exact")
    add("reductions", "numpy", "cumprod", lambda d, dev: np_.cumprod(
        1 + d["U"] * 0.01, axis=1), "red")
    for name, kw in [("nanmax", {}), ("nanmin", dict(axis=1)),
                     ("nanmean", {}), ("nanstd", dict(axis=0)),
                     ("nanvar", {}), ("nanmedian", dict(axis=1)),
                     ("nanpercentile", dict(q=40)),
                     ("nanquantile", dict(q=0.9, axis=0))]:
        add("reductions", "numpy", name, lambda d, dev, n=name, kw=kw:
            getattr(np_, n)(d["NAN"], **kw), "red")
    add("reductions", "numpy", "bincount", lambda d, dev: np_.bincount(
        d["TOK"].reshape(-1)), "exact")
    add("reductions", "numpy", "histogram", lambda d, dev: np_.histogram(
        d["A"], bins=64), "red")
    add("reductions", "numpy", "histogram2d", lambda d, dev: np_.histogram2d(
        d["A"][:, 0], d["B"][:, 0], bins=16), "red")
    add("reductions", "numpy", "histogram_bin_edges",
        lambda d, dev: np_.histogram_bin_edges(d["A"], bins=64), "red")
    add("reductions", "numpy", "cov", lambda d, dev: np_.cov(d["A"][:, :64],
                                                             rowvar=False),
        "red")
    add("reductions", "numpy", "corrcoef", lambda d, dev: np_.corrcoef(
        d["A"][:64]), "red")
    add("reductions", "numpy", "gradient", lambda d, dev: np_.gradient(
        d["A"], 0.5), "red")
    add("reductions", "numpy", "interp", lambda d, dev: np_.interp(
        d["A"].reshape(-1), d["S"], d["S"] * 2), "red")
    add("reductions", "numpy", "convolve", lambda d, dev: np_.convolve(
        d["V"], d["S"][:64]), "red")
    add("reductions", "numpy", "correlate", lambda d, dev: np_.correlate(
        d["V"], d["S"][:64], "same"), "red")
    # indexing, sorting, searching, sets
    for name, f in [
            ("where", lambda d: np_.where(d["AB"], d["A"], d["B"])),
            ("nonzero", lambda d: np_.nonzero(d["AB"][:64])),
            ("argwhere", lambda d: np_.argwhere(d["AB"][:64])),
            ("flatnonzero", lambda d: np_.flatnonzero(d["I"][:64])),
            ("take", lambda d: np_.take(d["A"], d["TOK"] % ARRAY_ROWS,
                                        axis=0)),
            ("take_along_axis", lambda d: np_.take_along_axis(
                d["A"], np_.argsort(d["A"], axis=1)[:, :8], 1)),
            ("put_along_axis", lambda d: np_.put_along_axis(
                d["A"].clone(), d["TOK"][:, :1] % ARRAY_UNITS,
                d["V"][:8, None], 1)[:8]),
            ("choose", lambda d: np_.choose(d["I"] % 3, [d["A"], d["B"],
                                                          d["P"]])),
            ("compress", lambda d: np_.compress(d["AB"][0], d["A"],
                                                axis=1)),
            ("extract", lambda d: np_.extract(d["AB"], d["A"])),
            ("select", lambda d: np_.select([d["A"] < -1, d["A"] > 1],
                                            [d["B"], d["P"]], 0.0)),
            ("piecewise", lambda d: np_.piecewise(
                d["A"], [d["A"] < 0, d["A"] >= 0],
                [lambda x: -x, lambda x: x * 2])),
            ("sort", lambda d: np_.sort(d["LOG"])),
            ("argsort", lambda d: np_.argsort(d["LOG"])),
            ("lexsort", lambda d: np_.lexsort([d["I"][0], d["I"][1] % 3])),
            ("partition", lambda d: np_.partition(d["LOG"], 100)),
            ("argpartition", lambda d: np_.argpartition(d["LOG"], 100)),
            ("searchsorted", lambda d: np_.searchsorted(
                np_.sort(d["LOG"][0]), d["LOG"][1:])),
            ("digitize", lambda d: np_.digitize(d["A"], d["S"])),
            ("unique", lambda d: np_.unique(d["TOK"], return_counts=True)),
            ("unique_values", lambda d: np_.unique_values(d["TOK"])),
            ("unique_counts", lambda d: np_.unique_counts(d["TOK"])),
            ("unique_inverse", lambda d: np_.unique_inverse(d["TOK"][0])),
            ("unique_all", lambda d: np_.unique_all(d["TOK"][0])),
            ("in1d", lambda d: np_.in1d(d["TOK"], d["TOK"][0])),
            ("isin", lambda d: np_.isin(d["TOK"], d["TOK"][0])),
            ("intersect1d", lambda d: np_.intersect1d(d["TOK"][0],
                                                      d["TOK"][1])),
            ("union1d", lambda d: np_.union1d(d["TOK"][0], d["TOK"][1])),
            ("setdiff1d", lambda d: np_.setdiff1d(d["TOK"][0], d["TOK"][1])),
            ("setxor1d", lambda d: np_.setxor1d(d["TOK"][0], d["TOK"][1])),
            ("unravel_index", lambda d: np_.unravel_index(
                d["TOK"].reshape(-1), (1024, 32))),
            ("ravel_multi_index", lambda d: np_.ravel_multi_index(
                (d["TOK"][0], d["TOK"][1]), (32000, 32000))),
            ("diag_indices_from", lambda d: np_.diag_indices_from(
                d["MAT"][0])),
            ("tril_indices_from", lambda d: np_.tril_indices_from(
                d["MAT"][0])),
            ("triu_indices_from", lambda d: np_.triu_indices_from(
                d["MAT"][0], 1)),
            ("mask_indices", lambda d: np_.mask_indices(
                256, np_.triu, 1, device=d["A"].device)),
            ("ix_", lambda d: np_.ix_(d["TOK"][0, :8], d["TOK"][1, :8])),
            ("packbits", lambda d: np_.packbits(d["AB"], axis=1)),
            ("unpackbits", lambda d: np_.unpackbits(np_.packbits(
                d["AB"], axis=1), axis=1)),
            ("sort_complex", lambda d: np_.sort_complex(d["V"]))]:
        add("indexing", "numpy", name, lambda d, dev, f=f: f(d), "exact")
    # products, polynomials, logic and the rest
    for name, f, kind in [
            ("inner", lambda d: np_.inner(d["A"][:256], d["B"][:256]), "red"),
            ("outer", lambda d: np_.outer(d["V"], d["V"]), "ew"),
            ("vdot", lambda d: np_.vdot(d["A"], d["B"]), "red"),
            ("vecdot", lambda d: np_.vecdot(d["A"], d["B"]), "red"),
            ("kron", lambda d: np_.kron(d["A"][:32, :32], d["B"][:16, :16]),
             "ew"),
            ("tensordot", lambda d: np_.tensordot(d["A"], d["B"],
                                                  ([0], [0])), "red"),
            ("einsum", lambda d: np_.einsum("bij,bjk->bik", d["MAT"],
                                            d["RHS"]), "red"),
            ("einsum_path", lambda d: np_.einsum_path(
                "ij,jk,kl->il", d["A"][:64, :64], d["B"][:64, :32],
                d["A"][:32, :16])[0], "exact"),
            ("trace", lambda d: np_.trace(d["MAT"], 0, 1, 2), "red"),
            ("cross", lambda d: np_.cross(d["C3"], d["D3"]), "ew"),
            ("polyval", lambda d: np_.polyval(d["POLY"], d["A"]), "red"),
            ("polyadd", lambda d: np_.polyadd(d["POLY"], d["V"][:2]), "ew"),
            ("polysub", lambda d: np_.polysub(d["POLY"], d["V"][:2]), "ew"),
            ("polymul", lambda d: np_.polymul(d["POLY"], d["V"]), "red"),
            ("polyder", lambda d: np_.polyder(d["V"], 2), "red"),
            ("polyint", lambda d: np_.polyint(d["V"]), "red"),
            ("polydiv", lambda d: np_.polydiv(d["V"][:64], d["V"].new_tensor(
                [2.0, 0.5])), "red"),
            ("poly", lambda d: np_.poly(d["S"][:16] / 4), "red"),
            ("roots", lambda d: np_.sort_complex(np_.roots(d["POLY"])),
             "red"),
            ("polyfit", lambda d: np_.polyfit(d["XS"], d["YS"], 2), "red"),
            ("vander", lambda d: np_.vander(d["S"][:256] / 2, 8), "red"),
            ("allclose", lambda d: np_.allclose(d["A"], d["A"] + 1e-7),
             "exact"),
            ("array_equal", lambda d: np_.array_equal(d["I"], d["I"]),
             "exact"),
            ("array_equiv", lambda d: np_.array_equiv(d["V"], d["A"][:1]),
             "exact"),
            ("shares_memory", lambda d: np_.shares_memory(d["A"],
                                                          d["A"][1:]),
             "exact"),
            ("may_share_memory", lambda d: np_.may_share_memory(d["A"],
                                                                d["B"]),
             "exact"),
            ("vectorize", lambda d: np_.vectorize(
                lambda x, y: (x * y).sum(), signature="(n),(n)->()")(
                    d["A"], d["B"]), "red"),
            ("apply_along_axis", lambda d: np_.apply_along_axis(
                lambda r: r * r.sum(), 1, d["A"][:512]), "red"),
            ("array_str", lambda d: np_.array_str(d["I"][:2, :4]), "exact"),
            ("array_repr", lambda d: np_.array_repr(d["I"][:2, :4]),
             "exact"),
            ("shape", lambda d: np_.shape(d["FX"]), "exact"),
            ("ndim", lambda d: np_.ndim(d["FX"]), "exact"),
            ("size", lambda d: np_.size(d["FX"], 1), "exact"),
            ("isscalar", lambda d: np_.isscalar(d["A"]), "exact"),
            ("iscomplexobj", lambda d: np_.iscomplexobj(d["A"]), "exact"),
            ("isrealobj", lambda d: np_.isrealobj(d["A"]), "exact"),
            ("iterable", lambda d: np_.iterable(d["A"]), "exact"),
            ("broadcast_shapes", lambda d: np_.broadcast_shapes(
                (8192, 1), (768,)), "exact"),
            ("result_type", lambda d: str(np_.result_type(d["I"], d["A"])),
             "exact"),
            ("promote_types", lambda d: str(np_.promote_types(
                "int64", "float32")), "exact"),
            ("can_cast", lambda d: np_.can_cast(d["I"], "float64"), "exact"),
            ("issubdtype", lambda d: np_.issubdtype(d["A"].dtype,
                                                    np_.floating), "exact"),
            ("isdtype", lambda d: np_.isdtype(d["I"].dtype, "integral"),
             "exact"),
            ("finfo", lambda d: np_.finfo(d["A"]).eps, "exact"),
            ("iinfo", lambda d: np_.iinfo(d["I"]).max, "exact"),
            ("dtype", lambda d: str(np_.dtype("float32")), "exact"),
            ("get_include", lambda d: np_.get_include(), "exact"),
            ("get_printoptions", lambda d: np_.get_printoptions()[
                "precision"], "exact"),
            ("set_printoptions", lambda d: np_.set_printoptions(), "exact"),
            ("printoptions", lambda d: _printed(np_, d["A"][:1, :3]),
             "exact")]:
        add("products, logic, misc", "numpy", name,
            lambda d, dev, f=f: f(d), kind)
    add("products, logic, misc", "numpy", "save", lambda d, dev: _files(
        np_, d["I"][:4], dev, "save"), "exact")
    add("products, logic, misc", "numpy", "savez", lambda d, dev: _files(
        np_, d["I"][:4], dev, "savez"), "exact")
    add("products, logic, misc", "numpy", "load", lambda d, dev: _files(
        np_, d["A"][:4], dev, "load"), "exact")
    add("products, logic, misc", "numpy", "fromfile", lambda d, dev: _files(
        np_, d["I"][:4], dev, "fromfile"), "exact")
    add("products, logic, misc", "numpy", "genfromtxt", lambda d, dev:
        _files(np_, d["I"][:4], dev, "genfromtxt"), "exact")
    # linear algebra on (64, 256, 256)
    for name, f in [
            ("det", lambda d: la.det(d["MAT"])),
            ("inv", lambda d: la.inv(d["MAT"])),
            ("solve", lambda d: la.solve(d["MAT"], d["RHS"])),
            ("norm", lambda d: la.norm(d["MAT"], axis=(1, 2))),
            ("pinv", lambda d: la.pinv(d["RECT"])),
            ("slogdet", lambda d: la.slogdet(d["MAT"])),
            ("matrix_rank", lambda d: la.matrix_rank(d["MAT"])),
            ("matrix_power", lambda d: la.matrix_power(d["MAT"], 3)),
            ("cholesky", lambda d: la.cholesky(d["B2"])),
            ("eigvalsh", lambda d: la.eigvalsh(d["B2"])),
            ("cond", lambda d: la.cond(d["MAT"])),
            ("multi_dot", lambda d: la.multi_dot([d["MAT"][0], d["MAT"][1],
                                                  d["RHS"][0]])),
            ("tensorinv", lambda d: la.tensorinv(d["MAT"][0].reshape(
                _mats_split(d)[0]), 1)),
            ("tensorsolve", lambda d: la.tensorsolve(d["MAT"][0].reshape(
                _mats_split(d)[1]), d["RHS"][0, :, 0].reshape(
                    _mats_split(d)[2]))),
            ("lstsq", lambda d: la.lstsq(d["RECT"][0], d["RHS"][0], None))]:
        add("linalg", "numpy.linalg", name, lambda d, dev, f=f: f(d), "mats")
    for name in ("qr", "svd", "eigh", "eig", "eigvals"):
        add("linalg", "numpy.linalg", name, lambda d, dev, n=name: n,
            _decomposition)
    # fft over (8, 1024, 768), last axis
    for name, kw in [("fft", {}), ("ifft", dict(norm="ortho")),
                     ("rfft", {}), ("irfft", {}), ("hfft", {}),
                     ("ihfft", {}), ("fft2", {}), ("ifft2", {}),
                     ("rfft2", {}), ("irfft2", {}), ("fftn", {}),
                     ("ifftn", dict(axes=(1, 2))), ("fftshift", {}),
                     ("ifftshift", dict(axes=2))]:
        add("fft", "numpy.fft", name, lambda d, dev, n=name, kw=kw:
            getattr(ff, n)(d["FX"], **kw), "red")
    add("fft", "numpy.fft", "fftfreq", lambda d, dev: ff.fftfreq(768, 0.5,
                                                                 device=dev))
    add("fft", "numpy.fft", "rfftfreq", lambda d, dev: ff.rfftfreq(
        768, device=dev))
    # npx at gpt_like and BERT-base widths
    for name, f, kind in [
            ("softmax", lambda d: npx.softmax(d["LOG"], temperature=0.7,
                                              length=d["TOK"][:, 0] % 32000),
             "ew"),
            ("log_softmax", lambda d: npx.log_softmax(d["LOG"],
                                                      temperature=2.0), "ew"),
            ("masked_softmax", lambda d: npx.masked_softmax(
                d["A"], d["AB"]), "ew"),
            ("masked_log_softmax", lambda d: npx.masked_log_softmax(
                d["A"], d["AB"]), "ew"),
            ("pick", lambda d: npx.pick(d["LOG"], d["TOK"][:, 0], mode="wrap"),
             "exact"),
            ("one_hot", lambda d: npx.one_hot(d["TOK"][:, :64], 512),
             "exact"),
            ("topk", lambda d: npx.topk(d["LOG"], k=50, ret_typ="both"),
             "exact"),
            ("gather_nd", lambda d: npx.gather_nd(d["A"], d["TOK"][:2] % 768),
             "exact"),
            ("scatter_nd", lambda d: npx.scatter_nd(
                d["V"][:512], d["TOK"][:2, :512] % 768, (768, 768)), "ew"),
            ("sequence_mask", lambda d: npx.sequence_mask(
                d["A"].reshape(128, 64, 768), d["TOK"][0, :64] % 129,
                use_sequence_length=True), "exact"),
            ("sequence_last", lambda d: npx.sequence_last(
                d["A"].reshape(128, 64, 768), d["TOK"][0, :64] % 128 + 1,
                use_sequence_length=True), "exact"),
            ("sequence_reverse", lambda d: npx.sequence_reverse(
                d["A"].reshape(128, 64, 768), d["TOK"][0, :64] % 128 + 1,
                use_sequence_length=True), "exact"),
            ("interleaved_matmul_selfatt_qk",
             lambda d: npx.interleaved_matmul_selfatt_qk(d["QKV"], 12),
             "red"),
            ("interleaved_matmul_selfatt_valatt",
             lambda d: npx.interleaved_matmul_selfatt_valatt(
                 d["QKV"], d["ATT"], 12), "red"),
            ("interleaved_matmul_encdec_qk",
             lambda d: npx.interleaved_matmul_encdec_qk(
                 d["A"].reshape(128, 64, 768)[:, :32], d["KV"], 12), "red"),
            ("interleaved_matmul_encdec_valatt",
             lambda d: npx.interleaved_matmul_encdec_valatt(
                 d["KV"], d["ATT"], 12), "red"),
            ("multi_head_attention", lambda d: npx.multi_head_attention(
                d["A"][:2048].reshape(2, 1024, 768),
                d["B"][:2048].reshape(2, 1024, 768),
                d["P"][:2048].reshape(2, 1024, 768), 12, causal=True),
             "red"),
            ("softmax_cross_entropy", lambda d: npx.softmax_cross_entropy(
                d["LOG"], d["TOK"][:, 0]), "red"),
            ("ctc_loss", lambda d: npx.ctc_loss(
                d["A"].reshape(128, 64, 768)[:, :8, :64], d["TOK"][:, :16]
                % 63 + 1), "red"),
            ("adaptive_avg_pool2d", lambda d: npx.adaptive_avg_pool2d(
                d["A"].reshape(8, 12, 256, 256), 4), "red"),
            ("arange_like", lambda d: npx.arange_like(d["A"]), "exact"),
            ("broadcast_like", lambda d: npx.broadcast_like(d["V"], d["A"]),
             "exact"),
            ("slice_like", lambda d: npx.slice_like(d["A"], d["MAT"][0]),
             "exact"),
            ("reshape_like", lambda d: npx.reshape_like(d["A"], d["KV"]),
             "exact"),
            ("batch_flatten", lambda d: npx.batch_flatten(d["FX"]), "exact"),
            ("slice", lambda d: npx.slice(d["A"], (None, 700), (4000, 0),
                                          (2, -3)), "exact"),
            ("shape_array", lambda d: npx.shape_array(d["FX"]), "exact"),
            ("reshape", lambda d: npx.reshape(d["FX"], (0, -4, 32, -1, -2)),
             "exact"),
            ("index_add", lambda d: npx.index_add(
                d["A"], d["TOK"][:2] % 768, d["S"][:1024] * 0 + 1.0), "ew"),
            ("index_update", lambda d: npx.index_update(
                d["A"], d["TOK"][:2, :1] % 768, d["V"][:1]), "exact"),
            ("index_copy", lambda d: npx.index_copy(
                d["A"], torch.arange(16, device=d["A"].device) * 7,
                d["B"][:16]), "exact"),
            ("boolean_mask", lambda d: npx.boolean_mask(d["A"],
                                                        d["AB"][:, 0]),
             "exact"),
            ("nonzero", lambda d: npx.nonzero(d["AB"][:256]), "exact"),
            ("constraint_check", lambda d: npx.constraint_check(
                d["P"] > 0), "exact"),
            ("smooth_l1", lambda d: npx.smooth_l1(d["A"], 2.0), "ew"),
            ("to_dlpack_for_read", lambda d: npx.from_dlpack(
                npx.to_dlpack_for_read(d["A"])), "exact"),
            ("to_dlpack_for_write", lambda d: npx.from_dlpack(
                npx.to_dlpack_for_write(d["A"])), "exact"),
            ("from_dlpack", lambda d: npx.from_dlpack(d["A"]), "exact"),
            ("save", lambda d: _files(npx, d["A"][:4], d["A"].device,
                                      "npx"), "exact"),
            ("load", lambda d: _files(npx, d["I"][:4], d["A"].device,
                                      "npx"), "exact")]:
        add("npx", "numpy_extension", name, lambda d, dev, f=f: f(d), kind)
    for name in ("relu", "sigmoid", "erf", "gammaln", "digamma",
                 "log_sigmoid", "hard_sigmoid", "silu", "swish", "mish",
                 "softplus"):
        add("npx", "numpy_extension", name, lambda d, dev, n=name:
            getattr(npx, n)(d["A"]))
    for name in ("rsqrt", "rcbrt", "gamma"):
        add("npx", "numpy_extension", name, lambda d, dev, n=name:
            getattr(npx, n)(d["P"]))
    add("npx", "numpy_extension", "erfinv", lambda d, dev: npx.erfinv(d["U"]))
    for name, f in [("cpu", lambda: str(npx.cpu())),
                    ("gpu", lambda: str(npx.gpu(0))),
                    ("current_context", lambda: str(npx.current_context())),
                    ("num_gpus", lambda: npx.num_gpus()),
                    ("is_np_array", lambda: npx.is_np_array()),
                    ("set_np", lambda: npx.set_np()),
                    ("reset_np", lambda: npx.reset_np()),
                    ("use_np", lambda: npx.use_np(len) is len),
                    ("waitall", lambda: npx.waitall())]:
        add("npx", "numpy_extension", name, lambda d, dev, f=f: f(), "exact")
    return cases


def _mats_split(d):
    """(m, r, r), (r, r, m) and (r, r) for matrices of side m = r * r."""
    m = d["MAT"].shape[-1]
    r = math.isqrt(m)
    return (m, r, r), (r, r, m), (r, r)


def _printed(np_, x):
    with np_.printoptions(precision=2):
        return np_.array_str(x)


def _files(mod, x, dev, what):
    """A round trip through a file in chiprun_out/, loaded on ``dev``."""
    path = os.path.join("chiprun_out", f"array_{what}_{dev.type}")
    os.makedirs("chiprun_out", exist_ok=True)
    if what in ("save", "load"):
        mod.save(path + ".npy", x)
        return mod.load(path + ".npy", device=dev)
    if what == "savez":
        mod.savez(path + ".npz", x, y=x)
        with mod.load(path + ".npz") as z:
            return [mod.array(z["arr_0"], device=dev),
                    mod.array(z["y"], device=dev)]
    if what == "fromfile":
        x.cpu().numpy().tofile(path)
        return mod.fromfile(path, dtype="int64", device=dev)
    if what == "genfromtxt":
        np.savetxt(path + ".txt", x.cpu().numpy(), fmt="%d")
        return mod.genfromtxt(path + ".txt", device=dev)
    mod.save(path + ".params", [x, x * 2])       # npx
    return mod.load(path + ".params", device=dev)


def _decomposition(torch, mx, d, dc, name):
    """qr, svd, eigh, eig, eigvals on the card against the CPU copy, by
    invariants: reconstructions, singular values and eigenvalues (as a
    set, nearest to nearest), |R| and |V|."""
    la = mx.np.linalg
    k = ARRAY_CPU_MATS
    if name == "qr":
        q, r = la.qr(d["RECT"])
        _, rc = la.qr(dc["RECT"][:k])
        outs = (q, r)
        err = max(_rel(q.double() @ r.double(), d["RECT"]),
                  _rel(r[:k].abs().cpu(), rc.abs()))
    elif name == "svd":
        u, s, vh = la.svd(d["RECT"])
        sc = la.svd(dc["RECT"][:k], compute_uv=False)
        outs = (u, s, vh)
        err = max(_rel((u.double() * s.double()[:, None, :])
                       @ vh.double(), d["RECT"]), _rel(s[:k].cpu(), sc))
    elif name == "eigh":
        w, v = la.eigh(d["B2"])
        wc = la.eigvalsh(dc["B2"][:k])
        outs = (w, v)
        vd = v.double()
        err = max(_rel((vd * w.double()[:, None, :]) @ vd.transpose(1, 2),
                       d["B2"]), _rel(w[:k].cpu(), wc))
        eigh_f64(torch, w[:k].cpu(), wc, dc["B2"][:k])
    else:
        a = d["MAT"][:k] if name == "eig" else d["MAT"]
        out = getattr(la, name)(a)
        w = out[0] if name == "eig" else out
        wc = la.eigvals(dc["MAT"][:k])
        outs = out if name == "eig" else (out,)
        gap = (w[:k].cpu()[:, :, None] - wc[:, None, :]).abs()
        err = gap.min(-1).values.max().item()
        if name == "eig":
            v = out[1]
            vd = v.cdouble()
            err = max(err, _rel(a.cdouble() @ vd,
                                vd * w.cdouble()[:, None, :]))
    return outs, err


def eigh_f64(torch, card, cpu, mats):
    """The card's and the CPU's f32 eigenvalues of ``mats`` against an f64
    eigvalsh of the same matrices: each side's largest error over the
    matrix's norm (its largest |eigenvalue|), printed beside the f32
    solvers' backward-error scale 256 * 2**-24 and kept as
    ``eigh_f64.last``."""
    w64 = torch.linalg.eigvalsh(mats.double())
    norm = w64.abs().max(-1, keepdim=True).values
    errs = {side: ((w.double() - w64).abs() / norm).max().item()
            for side, w in (("card", card), ("cpu", cpu))}
    scale = 256 * 2.0 ** -24
    worse = "card" if errs["card"] > errs["cpu"] else "CPU"
    print(f"phase 15 eigh against an f64 eigvalsh of the same "
          f"{mats.shape[0]} matrices: card {errs['card']:.3e}, CPU "
          f"{errs['cpu']:.3e} of the norm, {errs['card'] / scale:.2f}x and "
          f"{errs['cpu'] / scale:.2f}x of 256 * 2**-24 = {scale:.3e}; the "
          f"{worse} errs more", flush=True)
    eigh_f64.last = dict(errs, scale=scale)
    return errs


def _rel(a, b):
    """max |a - b| over max |b|, in f64 (complex128)."""
    a = a.cdouble() if a.is_complex() else a.double()
    b = b.cdouble() if b.is_complex() else b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for z in x for y in _flat(z)]
    return [x]


def _agree(torch, got, want, kind, what, dev):
    """The sweep's comparison of a card result with the CPU copy's."""
    got, want = _flat(got), _flat(want)
    check(len(got) == len(want), f"{what}: {len(got)} outputs, CPU "
          f"{len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if not isinstance(w, torch.Tensor):
            check(g == w or (isinstance(w, float) and math.isclose(
                g, w, rel_tol=1e-6)), f"{what}: {g!r} != {w!r}")
            continue
        check(g.device == dev, f"{what}: output on {g.device}")
        g = g.detach().cpu().resolve_conj().resolve_neg()
        w = w.detach().resolve_conj().resolve_neg()
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {tuple(g.shape)} {g.dtype} against the CPU's "
              f"{tuple(w.shape)} {w.dtype}")
        if kind == "exact" or not (w.is_floating_point() or w.is_complex()):
            same = torch.equal(g, w) or (w.is_floating_point() and bool(
                ((g == w) | (g.isnan() & w.isnan())).all()))
            check(same, f"{what}: not equal to the CPU's")
            continue
        tol = {"ew": ARRAY_EW, "red": ARRAY_RED, "mats": ARRAY_RED}[kind]
        fin = torch.isfinite(w)
        check(bool((torch.isfinite(g) == fin).all()),
              f"{what}: NaN or inf where the CPU's is finite, or not")
        if not bool(fin.any()):
            continue
        scale = w[fin].abs().max().item()
        err = (g[fin] - w[fin]).abs().max().item()
        check(err <= tol * (1 + scale),
              f"{what}: max_abs_err {err:.3e} > {tol} * (1 + {scale:.3e})")
        worst = max(worst, err / (1 + scale))
    return worst


def array_moments(torch, mx, dev):
    """Each sampler draws 2**24 values on the card: dtype, device, and the
    mean and variance of its distribution within ARRAY_MOMENT_TOL."""
    r = mx.np.random
    xr = mx.npx.random
    n = ARRAY_DRAWS
    pi = math.pi
    g = 0.5772156649015329
    cases = [
        ("uniform", r, dict(low=2.0, high=5.0), 3.5, 0.75),
        ("normal", r, dict(loc=1.0, scale=2.0), 1.0, 4.0),
        ("standard_normal", r, {}, 0.0, 1.0),
        ("exponential", r, dict(scale=2.0), 2.0, 4.0),
        ("gamma", r, dict(shape=3.0, scale=2.0), 6.0, 12.0),
        ("beta", r, dict(a=2.0, b=5.0), 2 / 7, 10 / (49 * 8)),
        ("chisquare", r, dict(df=4.0), 4.0, 8.0),
        ("f", r, dict(dfnum=10.0, dfden=20.0), 20 / 18,
         2 * 400 * 28 / (10 * 18 ** 2 * 16)),
        ("poisson", r, dict(lam=4.0), 4.0, 4.0),
        ("binomial", r, dict(n=10, p=0.3), 3.0, 2.1),
        ("negative_binomial", r, dict(n=5, p=0.5), 5.0, 10.0),
        ("geometric", r, dict(p=0.25), 4.0, 12.0),
        ("bernoulli", r, dict(prob=0.3), 0.3, 0.21),
        ("laplace", r, dict(loc=1.0, scale=2.0), 1.0, 8.0),
        ("logistic", r, dict(loc=1.0, scale=2.0), 1.0, 4 * pi ** 2 / 3),
        ("gumbel", r, {}, g, pi ** 2 / 6),
        ("lognormal", r, dict(mean=0.0, sigma=0.5), math.exp(0.125),
         (math.exp(0.25) - 1) * math.exp(0.25)),
        ("pareto", r, dict(a=5.0), 0.25, 5 / 48),
        ("power", r, dict(a=3.0), 0.75, 3 / 80),
        ("rayleigh", r, dict(scale=2.0), 2 * math.sqrt(pi / 2),
         (4 - pi) / 2 * 4),
        ("weibull", r, dict(a=2.0), math.sqrt(pi) / 2, 1 - pi / 4),
        ("bernoulli", xr, dict(logit=0.0), 0.5, 0.25),
    ]
    out = {}
    for name, mod, kw, mean, var in cases:
        x = getattr(mod, name)(size=(n,), device=dev, **kw)
        check(x.device == dev and x.shape == (n,), f"{name}: {x.device} "
              f"{tuple(x.shape)}")
        m, v = x.double().mean().item(), x.double().var().item()
        se = math.sqrt(var / n)              # the mean's standard error
        check(abs(m - mean) <= ARRAY_MOMENT_TOL * abs(mean) + 6 * se
              and abs(v - var) <= ARRAY_MOMENT_TOL * var + 6 * se,
              f"{name}: mean {m} var {v}, expected {mean} {var}")
        out[f"{mod.__name__.split('.')[-2]}.{name}"] = [m, v]
    on = dict(device=dev)
    extra = [("randn", r.randn(4096, 4096, **on)),
             ("rand", r.rand(4096, 4096, **on)),
             ("choice", r.choice(ARRAY_VOCAB, size=(n,), **on)),
             ("choice", r.choice(ARRAY_VOCAB, size=(4096,), replace=False,
                                 **on)),
             ("permutation", r.permutation(n, **on)),
             ("multinomial", r.multinomial(8, [0.25] * 4, size=(1 << 20,),
                                           **on)),
             ("multivariate_normal", r.multivariate_normal(
                 [1.0, -1.0], [[2.0, 0.6], [0.6, 1.0]], size=(n,), **on)),
             ("uniform_n", xr.uniform_n(0.0, 4.0, batch_shape=(n,), **on)),
             ("normal_n", xr.normal_n(1.0, 2.0, batch_shape=(n,), **on))]
    for name, x in extra:
        check(x.device == dev, f"{name} on {x.device}")
    p = extra[4][1]
    check(torch.equal(p.sort().values, torch.arange(n, device=dev)),
          "permutation is not one")
    check(len(extra[3][1].unique()) == 4096, "choice without replacement")
    mv = extra[6][1]
    check(abs(mv[:, 0].mean().item() - 1.0) < 0.01
          and abs(torch.cov(mv.T)[0, 1].item() - 0.6) < 0.01,
          "multivariate_normal moments")
    check(bool((extra[5][1].sum(1) == 8).all()), "multinomial counts")
    x = torch.arange(4096.0, device=dev)
    r.shuffle(x)
    check(torch.equal(x.sort().values, torch.arange(4096.0, device=dev)),
          "shuffle lost values")
    r.seed(SEED + 15)
    a = r.gamma(2.0, size=(1024,), **on)
    r.seed(SEED + 15)
    check(torch.equal(a, r.gamma(2.0, size=(1024,), **on)), "seed does not "
          "reproduce the draws")
    names = {c[0] for c in cases} | {e[0] for e in extra} | {"shuffle",
                                                             "seed"}
    return out, names


def array_sweep(torch, mx, dev):
    """Phase 15 (a): every function this PR ports on the card against the
    CPU copy; the count against the modules' public callables."""
    import inspect

    cases = array_cases(torch, mx)
    d = array_inputs(torch, dev)
    dc = {k: v.cpu() for k, v in d.items()}
    fam_ms, fam_n, worst, card_ms = {}, {}, {}, {}
    swept = {}
    for family, mod, name, fn, kind in cases:
        t0 = time.perf_counter()
        if callable(kind):
            outs, err = kind(torch, mx, d, dc, name)
            for o in _flat(outs):
                check(o.device == dev, f"{name}: output on {o.device}")
            tol = ARRAY_DECOMP_TOL
            check(err <= tol, f"linalg.{name}: {err:.3e} > {tol}")
            worst[f"linalg.{name}"] = err
        else:
            t1 = time.perf_counter()
            got = fn(d, dev)
            torch.cuda.synchronize()
            card_ms[family] = card_ms.get(family, 0.0) + 1e3 * (
                time.perf_counter() - t1)
            if kind == "mats" or family == "elementwise":
                k, n0 = (ARRAY_CPU_MATS, ARRAY_MATS[0]) if kind == "mats" \
                    else (ARRAY_CPU_ROWS, ARRAY_ROWS)
                dk = {key: (v[:k] if v.dim() and v.shape[0] == n0 else v)
                      for key, v in dc.items()}
                want = _flat(fn(dk, torch.device("cpu")))
                got = [g[:w.shape[0]] if isinstance(g, torch.Tensor)
                       and g.dim() and g.shape[0] != w.shape[0] else g
                       for g, w in zip(_flat(got), want)]
            else:
                want = fn(dc, torch.device("cpu"))
            worst[f"{mod}.{name}"] = max(worst.get(f"{mod}.{name}", 0.0),
                                         _agree(torch, got, want, kind,
                                                f"{mod}.{name}", dev))
        torch.cuda.synchronize()
        fam_ms[family] = fam_ms.get(family, 0.0) + 1e3 * (
            time.perf_counter() - t0)
        fam_n[family] = fam_n.get(family, 0) + 1
        swept.setdefault(mod, set()).add(name)
    t0 = time.perf_counter()
    moments, sampled = array_moments(torch, mx, dev)
    fam_ms["random"] = card_ms["random"] = 1e3 * (time.perf_counter() - t0)
    fam_n["random"] = len(sampled)
    swept.setdefault("numpy.random", set()).update(
        sampled - {"uniform_n", "normal_n", "uniform", "normal", "seed"})
    # npx.bernoulli, uniform_n, normal_n and seed are npx.random's
    for mod in ("numpy_extension", "numpy_extension.random"):
        swept.setdefault(mod, set()).update({"uniform_n", "normal_n",
                                             "bernoulli"})
    swept["numpy_extension"].add("seed")
    public, n_public = {}, 0
    for mod in ARRAY_EARLIER.keys() | ARRAY_NOT_API.keys():
        m = __import__(f"mxnet_tpu_torch.{mod}", fromlist=["_"])
        skip = set(ARRAY_EARLIER.get(mod, "").split()) | set(
            ARRAY_NOT_API.get(mod, "").split())
        names = {n for n in dir(m) if not n.startswith("_")
                 and callable(getattr(m, n))
                 and not inspect.ismodule(getattr(m, n))} - skip
        public[mod] = names
        n_public += len(names)
    # npx.random re-exports np.random: one function, swept once
    same = {n for n in public["numpy_extension.random"]
            if getattr(mx.npx.random, n) is getattr(mx.np.random, n, None)}
    public["numpy_extension.random"] -= same
    n_public -= len(same)
    n_swept = sum(len(v) for v in swept.values())
    missing = {m: sorted(public[m] - swept.get(m, set())) for m in public}
    extra = {m: sorted(swept[m] - public.get(m, set())) for m in swept}
    print(f"phase 15 sweep: {n_swept} functions swept on {dev}, against "
          f"{n_public} public callables of np, np.linalg, np.fft, "
          "np.random, npx and npx.random less the listed exclusions "
          "(earlier slices, imports, numpy's type classes)", flush=True)
    check({k: v for k, v in missing.items() if v} == {}
          and {k: v for k, v in extra.items() if v} == {}
          and n_swept == n_public,
          f"swept {n_swept} against {n_public}: not swept {missing}, not "
          f"public {extra}")
    for fam in fam_ms:
        print(f"  {fam}: {fam_n[fam]} functions, {fam_ms[fam]:.1f} ms "
              f"with the CPU copy, {card_ms.get(fam, fam_ms[fam]):.1f} ms "
              "of calls on the card (host clock, first calls, each "
              "synchronised)", flush=True)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
    print("  largest errors against the CPU copy (of 1 + the largest "
          "magnitude; decompositions relative): "
          + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
    return {"swept": n_swept, "public": n_public, "family_ms": fam_ms,
            "family_card_ms": card_ms,
            "family_n": fam_n, "worst_rel_err": worst, "moments": moments}


def array_out_of_range(torch, mx, dev):
    """Phase 15 (b): negative and too-large indices on the card give the
    port's CPU values (the CPU tests hold those to the reference's), with
    a synchronize after each and the context healthy after all;
    index_copy raises MXNetError, as the reference does."""
    from mxnet_tpu_torch.base import MXNetError

    np_, npx = mx.np, mx.npx
    rng = np.random.RandomState(SEED + 15)
    x = torch.from_numpy(rng.randn(64, 768).astype(np.float32))
    idx = torch.tensor([[-1, 64, -65, 3, 1000, -1000]])
    idx2 = torch.tensor([[-1, 64, -65, 3], [800, -2, 5, -769]])
    vals = torch.arange(1.0, 5.0)
    calls = {
        "take": lambda x, i, i2, v: np_.take(x, i, axis=0),
        "take_wrap": lambda x, i, i2, v: np_.take(x, i, axis=1, mode="wrap"),
        "pick": lambda x, i, i2, v: npx.pick(x[:6], i[0]),
        "gather_nd": lambda x, i, i2, v: npx.gather_nd(x, i2),
        "scatter_nd": lambda x, i, i2, v: npx.scatter_nd(v, i2, (64, 768)),
        "one_hot": lambda x, i, i2, v: npx.one_hot(i, 64),
        "index_add": lambda x, i, i2, v: npx.index_add(x, i2, v),
        "index_update": lambda x, i, i2, v: npx.index_update(x, i2, v),
    }
    out = {}
    for name, f in calls.items():
        want = f(x, idx, idx2, vals)
        got = f(x.to(dev), idx.to(dev), idx2.to(dev), vals.to(dev))
        torch.cuda.synchronize()
        check(got.device == dev and torch.equal(got.cpu(), want),
              f"{name} with out-of-range indices differs from the CPU's")
        out[name] = "equal"
    try:
        npx.index_copy(x.to(dev), torch.tensor([0, 64], device=dev),
                       x[:2].to(dev))
        raise RuntimeError("index_copy accepted an out-of-range index")
    except MXNetError:
        out["index_copy"] = "MXNetError"
    torch.cuda.synchronize()
    y = (torch.ones(1024, device=dev) * 2).sum().item()
    check(y == 2048.0, "CUDA context unhealthy after the index checks")
    print(f"phase 15 out-of-range indices on {dev}: {out}; the context is "
          "healthy after them", flush=True)
    return out


def array_capture_guard(torch, mx, dev):
    """A hybridized block calling np.nonzero: its graph capture raises
    MXNetError naming the function (not a CUDA capture error), and the
    card stays usable."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import HybridBlock

    class Nonzero(HybridBlock):
        def forward(self, x):
            return mx.np.nonzero(x > 0)[0] + x.sum().long()

    net = Nonzero()
    net.initialize(device=dev)
    net.hybridize()
    x = torch.randn(64, device=dev)
    msg = None
    try:
        for _ in range(3):
            net(x)
    except MXNetError as err:
        msg = str(err)
    check(msg is not None and "nonzero" in msg,
          f"the hybridized nonzero did not raise MXNetError: {msg}")
    torch.cuda.synchronize()
    check(torch.equal(mx.np.nonzero(x > 0)[0].cpu(),
                      torch.nonzero(x.cpu() > 0)[:, 0]),
          "nonzero after the refused capture")
    print(f"phase 15 capture guard: {msg}", flush=True)
    return msg


# MXNet's interleaved self-attention at BERT-base's widths, under highest,
# against ops.nn.attend: K1 forward (one TF32-split product per pass, an
# online softmax) against the interleaved path's IEEE f32 products and a
# two-pass softmax: the CPU tests hold K1 to 1e-4 of plain attention at
# these widths' scores
ARRAY_ATT_L, ARRAY_ATT_B, ARRAY_ATT_H, ARRAY_ATT_D = 128, 32, 12, 64
ARRAY_ATT_TOL = 1e-4


def array_selfatt(torch, mx, dev, wrappers):
    """Phase 15 (c): layer 0's Q, K and V weights of the port's bert_base
    (seed 0) interleaved into ``_split_selfatt``'s per-head layout;
    interleaved_matmul_selfatt_qk -> masked_softmax -> _valatt held
    against ops.nn.attend, which launches K1 forward exactly once, at full
    lengths; at valid lengths 64..128 (a sequence_mask mask, and
    softmax(length=)) against attend's masked path."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_base
    from mxnet_tpu_torch.ops import nn as tnn

    npx = mx.npx
    L, B, H, D = ARRAY_ATT_L, ARRAY_ATT_B, ARRAY_ATT_H, ARRAY_ATT_D
    U = H * D
    mx.np.random.seed(SEED)
    bert = bert_base(dropout=0.0)
    bert.initialize(device=dev)
    attn = bert.encoder.layer0.attn
    w = attn.qkv.weight.data().detach()            # (3U, U): [Q; K; V]
    b = attn.qkv.bias.data().detach()
    # row (h, j, d) of the interleaved weight is row j * U + h * D + d
    order = torch.arange(3 * U, device=dev).reshape(3, H, D) \
        .transpose(0, 1).reshape(-1)
    w_int, b_int = w[order], b[order]
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 15)
    x = torch.randn(L, B, U, generator=g, device=dev)      # (L, B, U)
    qkv = x @ w_int.T + b_int                              # (L, B, 3U)
    full = torch.ones(B * H, L, L, dtype=torch.bool, device=dev)
    for wr in wrappers.values():
        wr.launches = 0
    qk = npx.interleaved_matmul_selfatt_qk(qkv, H)
    att = npx.masked_softmax(qk, full)
    got = npx.interleaved_matmul_selfatt_valatt(qkv, att, H)   # (L, B, U)
    p = x.transpose(0, 1) @ w.T + b                        # (B, L, 3U)
    q, k, v = p[..., :U], p[..., U:2 * U], p[..., 2 * U:]
    launches = {n: wr.launches for n, wr in wrappers.items()}
    ref = tnn.attend(q, k, v, H)                          # K1 forward
    torch.cuda.synchronize()
    k1 = {n: wr.launches - launches[n] for n, wr in wrappers.items()}
    check(k1 == dict({n: 0 for n in wrappers}, flash_attention_fwd=1),
          f"attend at full lengths launched {k1}, not K1 forward once")
    scale = ref.abs().max().item()
    err_full = (got.transpose(0, 1) - ref).abs().max().item()
    # valid lengths 64..128: sequence_mask over the keys, and softmax's
    # length (one per row of axis 0, B * H rows)
    lengths = torch.from_numpy(np.random.RandomState(SEED + 16).randint(
        64, L + 1, B)).to(dev)
    keep = npx.sequence_mask(torch.ones(L, B, device=dev), lengths,
                             use_sequence_length=True, axis=0).T.bool()
    mask = keep[:, None, None, :].expand(B, H, L, L).reshape(B * H, L, L)
    got_mask = npx.interleaved_matmul_selfatt_valatt(
        qkv, npx.masked_softmax(qk, mask), H)
    got_len = npx.interleaved_matmul_selfatt_valatt(
        qkv, npx.softmax(qk, length=lengths.repeat_interleave(H)), H)
    before = {n: wr.launches for n, wr in wrappers.items()}
    ref_mask = tnn.attend(q, k, v, H, mask=keep[:, None, None, :])
    torch.cuda.synchronize()
    check(all(wr.launches == before[n] for n, wr in wrappers.items()),
          "attend's masked path launched a kernel")
    err_mask = (got_mask.transpose(0, 1) - ref_mask).abs().max().item()
    err_len = (got_len.transpose(0, 1) - ref_mask).abs().max().item()
    scale_m = ref_mask.abs().max().item()
    print(f"phase 15 interleaved self-attention (L {L}, B {B}, H {H}, D {D},"
          f" highest): against attend (K1 forward, launched {k1[
              'flash_attention_fwd']} time) max_abs_err {err_full:.3e} of "
          f"max {scale:.3f}; valid lengths {int(lengths.min())}.."
          f"{int(lengths.max())} against attend's masked path: "
          f"masked_softmax {err_mask:.3e}, softmax(length=) {err_len:.3e} "
          f"of max {scale_m:.3f} (tol {ARRAY_ATT_TOL} relative)",
          flush=True)
    check(err_full <= ARRAY_ATT_TOL * scale, f"interleaved against K1: "
          f"{err_full} > {ARRAY_ATT_TOL} * {scale}")
    check(max(err_mask, err_len) <= ARRAY_ATT_TOL * scale_m,
          f"interleaved masked: {err_mask}, {err_len} > {ARRAY_ATT_TOL} * "
          f"{scale_m}")
    del bert
    return {"err_full": err_full, "scale_full": scale,
            "err_masked_softmax": err_mask, "err_softmax_length": err_len,
            "scale_masked": scale_m, "k1_launches": k1,
            "lengths": lengths.tolist()}


def array_phase(torch, card, wrappers):
    """Phase 15: the array layer (:func:`array_sweep`,
    :func:`array_out_of_range`, :func:`array_selfatt`,
    :func:`array_capture_guard`), under highest."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import matmul_precision_scope

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    with matmul_precision_scope("highest"):
        out = {"sweep": array_sweep(torch, mx, dev)}
        out["eigh_f64"] = getattr(eigh_f64, "last", None)
        torch.cuda.empty_cache()
        out["out_of_range"] = array_out_of_range(torch, mx, dev)
        out["selfatt"] = array_selfatt(torch, mx, dev, wrappers)
        out["capture_guard"] = array_capture_guard(torch, mx, dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 15 took {out['seconds']:.1f} s on {card}", flush=True)
    return out


# -- phase 16: SSD300 detection and the contrib ops ---------------------------
# SSD300 as published (Liu et al., SSD: Single Shot MultiBox Detector,
# ECCV 2016, §2.2-3): six maps, sizes 30..315 over 300, each map
# (s_k, sqrt(s_k s_k+1)), ratios {1, 2, 1/2} on the first map and the last
# two and {1, 2, 1/2, 3, 1/3} on the others: 8732 anchors. The backbone is
# the port's resnet50_v1 body at 300x300 (stride 8, 16 and 32 stages: 38,
# 19 and 10 cells), three extra blocks (10 -> 5 -> 3 -> 1), and per map a
# 3x3 convolution for anchors x 21 class scores (Pascal VOC's 20 and the
# background) and one for anchors x 4 offsets. Trained as
# example/gluon/ssd.py:174-222 trains (multibox_target under pause, 3:1
# hard negatives, the weighted cross entropy and the masked L1, Adam at
# 2e-3) on 32 synthetic images of 1-8 rectangles from numpy seed 0, under
# the default policy; the ops' checks run under highest.
DET_SIZE, DET_B, DET_STEPS, DET_CLASSES, DET_MAX_OBJ = 300, 32, 10, 20, 8
DET_SIZES = (30, 60, 111, 162, 213, 264, 315)
DET_RATIOS = [(1, 2, 0.5) if i in (0, 4, 5) else (1, 2, 0.5, 3, 1 / 3)
              for i in range(6)]
DET_ANCHORS = 8732
DET_EXTRAS = ((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 1, 0))
DET_CPU_IMAGES = 8               # the CPU copies' slice of a batch
DET_CPU_ROIS = 64
DET_EW, DET_DEF = 1e-5, 1e-4     # f32 values; deformable products, foreach
DET_NEAR = 1e-6                  # an IoU this close to its threshold may tie
DET_THRESH = dict(threshold=0.01, nms_threshold=0.45, nms_topk=400)
DET_LSTM = (768, 32, 128)        # units, batch, steps of foreach's cell
# the detection-model ops' published shapes: (data shape, rois, image
# width and height the rois fall in)
DET_ROI_ALIGN = ((2, 256, 200, 336), 1024, 1333, 800)    # Mask R-CNN P2
DET_ROI_POOL = ((2, 512, 38, 50), 256, 800, 608)         # Fast R-CNN conv5
DET_PSROI = ((1, 21 * 49, 38, 63), 300, 1000, 600)       # R-FCN's head
DET_DCN = (2, 512, 25, 42)                               # ResNet-50 res5
DET_SSD_MAP = (32, 256, 38, 38)                          # SSD's first map


def ssd300(mx, classes=DET_CLASSES):
    """SSD300 over the port's resnet50_v1 body (a HybridBlock)."""
    from mxnet_tpu_torch.gluon import HybridBlock, nn
    from mxnet_tpu_torch.gluon.model_zoo import vision

    class SSD(HybridBlock):
        def __init__(self):
            super().__init__()
            self.body = vision.resnet50_v1().features   # stem, 4 stages, GAP
            self.extras = nn.HybridSequential()
            for mid, out, stride, pad in DET_EXTRAS:
                blk = nn.HybridSequential()
                blk.add(nn.Conv2D(mid, 1, activation="relu"),
                        nn.Conv2D(out, 3, strides=stride, padding=pad,
                                  activation="relu"))
                self.extras.add(blk)
            self.cls_heads = nn.HybridSequential()
            self.box_heads = nn.HybridSequential()
            for sizes, ratios in zip(DET_SIZES, DET_RATIOS):
                n = len(ratios) + 1
                self.cls_heads.add(nn.Conv2D(n * (classes + 1), 3,
                                             padding=1))
                self.box_heads.add(nn.Conv2D(n * 4, 3, padding=1))

        def forward(self, x):
            feats, y = [], x
            for i in range(8):                     # through stage 4
                y = self.body[i](y)
                if i >= 5:
                    feats.append(y)
            for blk in self.extras:
                y = blk(y)
                feats.append(y)
            anchors, cls, box = [], [], []
            b = x.shape[0]
            for k, f in enumerate(feats):
                s = (DET_SIZES[k] / 300,
                     math.sqrt(DET_SIZES[k] * DET_SIZES[k + 1]) / 300)
                anchors.append(mx.npx.multibox_prior(f, sizes=s,
                                                     ratios=DET_RATIOS[k]))
                cls.append(self.cls_heads[k](f).permute(0, 2, 3, 1).reshape(
                    b, -1, classes + 1))
                box.append(self.box_heads[k](f).permute(0, 2, 3, 1).reshape(
                    b, -1))
            return (mx.np.concatenate(anchors, axis=1),
                    mx.np.concatenate(cls, axis=1),
                    mx.np.concatenate(box, axis=1))

    return SSD()


def ssd_weights(net, seed):
    """Numpy weights under the port's names: the ResNet body's as
    :func:`resnet_weights` makes them, the extra and head convolutions
    normal with He's std sqrt(2 / fan_in) (the heads 0.1x), biases 0."""
    out = {f"body.{n}": v for n, v in resnet_weights(net.body, seed).items()}
    rng = np.random.default_rng(seed + 1)
    for name, p in net.collect_params().items():
        if name.startswith("body."):
            continue
        shape = tuple(p.shape)
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
            continue
        std = math.sqrt(2.0 / int(np.prod(shape[1:])))
        if "heads" in name:
            std *= 0.1
        out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def det_images(n, seed, size=DET_SIZE):
    """n RGB images of 1..DET_MAX_OBJ axis-aligned rectangles of 20
    classes, filled (even classes) or hollow (odd) in a class colour on
    noise, as example/gluon/ssd.py:89-110 draws them; labels (n,
    DET_MAX_OBJ, 5) of [cls, l, t, r, b] in [0, 1], padded with -1."""
    rng = np.random.RandomState(seed)
    colour = rng.uniform(0.3, 1.0, (DET_CLASSES, 3)).astype(np.float32)
    imgs = (rng.rand(n, 3, size, size) * 0.1).astype(np.float32)
    labels = np.full((n, DET_MAX_OBJ, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(rng.randint(1, DET_MAX_OBJ + 1)):
            w, h = rng.randint(size // 10, size // 2, 2)
            x, y = rng.randint(0, size - w), rng.randint(0, size - h)
            c = rng.randint(0, DET_CLASSES)
            imgs[i, :, y:y + h, x:x + w] = colour[c][:, None, None]
            if c % 2:
                imgs[i, :, y + 3:y + h - 3, x + 3:x + w - 3] = 0.0
            labels[i, j] = [c, x / size, y / size, (x + w) / size,
                            (y + h) / size]
    return imgs, labels


def det_loss(mx, cls_pred, box_pred, loc_t, loc_m, cls_t, loss_fn):
    """The example's loss (ssd.py:213-218)."""
    c = cls_pred.shape[-1]
    cls_l = loss_fn(cls_pred.reshape(-1, c), cls_t.reshape(-1))
    w = (cls_t.reshape(-1) >= 0).float()
    cls_l = (cls_l * w).sum() / mx.np.maximum(w.sum(), 1.0)
    loc_l = (mx.np.abs((box_pred - loc_t) * loc_m)).sum() / \
        mx.np.maximum(loc_m.sum(), 1.0)
    return cls_l + loc_l


class no_host_sync:
    """``torch.cuda.set_sync_debug_mode("error")`` for the scope: an op
    that waits for the card on the host raises."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)


def event_ms(torch, fn, guard=False):
    """(result, ms between two CUDA events around one call of fn): the
    card's elapsed time, launch gaps included; with ``guard`` the call
    runs under :class:`no_host_sync` (the wait for the end event after
    it)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    with no_host_sync(torch) if guard else nullcontext():
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profiled_launches(torch, fn):
    """(kernels and copies launched, their device ms summed) of one call
    of fn, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(evs), sum(e.device_time_total for e in evs) / 1e3


def _max_rel(torch, got, want):
    """max |got - want| over 1 + max |want|, in f64."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if want.numel() == 0:
        return 0.0
    return ((got - want).abs().max() / (1 + want.abs().max())).item()


def target_diffs(torch, got, want, anchors, labels):
    """Anchors whose class target or mask differ between the card and its
    CPU copy; allowed only where the anchor's best IoU with a ground
    truth lies within DET_NEAR of 0.5 (the overlap and mining
    thresholds)."""
    from mxnet_tpu_torch.ops.contrib import _iou_corner

    bad = []
    g_cls, w_cls = got[2].cpu(), want[2]
    g_m = got[1].cpu().reshape(g_cls.shape + (4,))[..., 0]
    w_m = want[1].reshape(w_cls.shape + (4,))[..., 0]
    diff = ((g_cls != w_cls) | (g_m != w_m)).nonzero().tolist()
    for n, a in diff:
        lab = labels[n][labels[n][:, 0] != -1]
        iou = _iou_corner(anchors[0, a:a + 1].double().cpu(),
                          lab[:, 1:5].double()).max().item()
        print(f"  multibox_target: image {n} anchor {a} differs (card "
              f"{g_cls[n, a].item()}, CPU {w_cls[n, a].item()}), its best "
              f"IoU {iou:.9f}", flush=True)
        if abs(iou - 0.5) >= DET_NEAR:
            bad.append((n, a, iou))
    return diff, bad


def nms_diffs(torch, what, keep_got, keep_want, boxes, cls, thresh):
    """Sorted rows kept on one side only of an NMS (``keep_got`` on the
    card, ``keep_want`` on its CPU copy, (K,) bool; ``boxes`` (K, 4);
    ``cls`` (K,) the rows' classes, or None where any row suppresses
    any). A differing row is allowed only where its own IoU with a
    higher-scored row of its class, kept on either side, lies within
    DET_NEAR of ``thresh`` (a tie), or reaches ``thresh`` - DET_NEAR
    with an earlier differing row allowed so (that row's kept state
    differs, so it suppresses this one on one side only). Prints each
    differing row with that IoU; returns (differing rows, rows not
    allowed)."""
    from mxnet_tpu_torch.ops.contrib import _iou_corner

    kept = keep_got | keep_want
    boxes = boxes.double()
    diff = (keep_got != keep_want).nonzero().flatten().tolist()
    allowed, bad = set(), []
    for i in diff:
        prev = kept[:i].clone()
        if cls is not None:
            prev &= cls[:i] == cls[i]
        j = prev.nonzero().flatten()
        iou = _iou_corner(boxes[i:i + 1], boxes[j])[0] if len(j) else \
            boxes.new_zeros(0)
        tie = (iou - thresh).abs() < DET_NEAR
        late = torch.tensor([int(x) in allowed for x in j], dtype=torch.bool)
        cascade = late & (iou >= thresh - DET_NEAR)
        if tie.any():
            k, why = int((iou - thresh).abs().argmin()), "a tie"
        elif cascade.any():
            k, why = int(cascade.nonzero()[0]), "after a differing row"
        else:
            k = int((iou - thresh).abs().argmin()) if len(j) else -1
            why = "NOT ALLOWED"
        near = f"row {int(j[k])} at IoU {iou[k].item():.9f}" if k >= 0 \
            else "no earlier kept row"
        print(f"  {what}: sorted row {i} kept on the "
              f"{'card' if keep_got[i] else 'CPU'} only; {near} ({why})",
              flush=True)
        if why == "NOT ALLOWED":
            bad.append(i)
        else:
            allowed.add(i)
    return diff, bad


def detection_diffs(torch, got, want, thresh, force_suppress=False):
    """Images whose kept rows differ between the card's multibox_detection
    (``got``) and its CPU copy's (``want``), each row held by
    :func:`nms_diffs` (a suppressed row keeps its score and box, so the
    class of a row kept on either side is the larger of the two ids).
    Returns (differing images, (image, row) pairs not allowed)."""
    diff, bad = [], []
    for n in range(want.shape[0]):
        g, w = got[n, :, 0].cpu(), want[n, :, 0]
        if torch.equal(g, w):
            continue
        diff.append(n)
        cls = None if force_suppress else torch.maximum(g, w)
        _, b = nms_diffs(torch, f"multibox_detection image {n}", g >= 0,
                         w >= 0, want[n, :, 2:6], cls, thresh)
        bad += [(n, i) for i in b]
    return diff, bad


def det_train(torch, mx, card, wrappers, dev):
    """Phase 16 (a): SSD300 trains DET_STEPS steps through the example's
    loop; multibox_target runs with no host sync; K3 exactly once a
    step; the loss falls. Returns the results, the net and step 0's
    target inputs and outputs."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params

    t0 = time.perf_counter()
    net = ssd300(mx)
    net.initialize(device=dev)
    imgs, labels = det_images(DET_B, SEED)
    x = torch.from_numpy(imgs).to(dev)
    y = torch.from_numpy(labels).to(dev)
    with torch.no_grad():
        anchors, cls_pred, box_pred = net(x[:1])     # completes the shapes
    check(tuple(anchors.shape) == (1, DET_ANCHORS, 4)
          and tuple(cls_pred.shape) == (1, DET_ANCHORS, DET_CLASSES + 1)
          and tuple(box_pred.shape) == (1, DET_ANCHORS * 4),
          f"SSD300 shapes {anchors.shape} {cls_pred.shape} {box_pred.shape}")
    from_jax_params(ssd_weights(net, SEED + 16), net)
    n_params = sum(p.data().numel() for p in net.collect_params().values())
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 2e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    print(f"phase 16 SSD300: resnet50_v1 body, {DET_ANCHORS} anchors, "
          f"{n_params} parameters on {dev}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    losses, step_ms, tgt_ms = [], [], []
    saved = None
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    with matmul_precision_scope("default"):
        for step in range(DET_STEPS):
            t0 = time.perf_counter()
            with autograd.record():
                anchors, cls_pred, box_pred = net(x)
                with autograd.pause():
                    cls_t = cls_pred.transpose(1, 2)
                    ev[0].record()
                    with no_host_sync(torch):
                        tgt = mx.npx.multibox_target(
                            anchors, y, cls_t, negative_mining_ratio=3.0)
                    ev[1].record()
                    loc_t, loc_m, cls_tgt = tgt
                loss = det_loss(mx, cls_pred, box_pred, loc_t, loc_m,
                                cls_tgt, loss_fn)
            autograd.backward(loss)
            trainer.step(1)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            tgt_ms.append(ev[0].elapsed_time(ev[1]))
            losses.append(float(loss))
            if step == 0:
                saved = (anchors.detach(), y, cls_t.detach().clone(),
                         [t.clone() for t in tgt])
        counts = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        n_launch, kern_ms = profiled_launches(
            torch, lambda: mx.npx.multibox_target(
                saved[0], saved[1], saved[2], negative_mining_ratio=3.0))
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    tail = float(np.mean(losses[-5:]))
    check(tail < losses[0], f"SSD300 loss did not fall: {losses}")
    expected = dict({k: 0 for k in wrappers}, cross_entropy_lse=DET_STEPS)
    check(counts == expected, f"SSD300 launches {counts} != {expected}")
    k3 = det_k3(torch, saved)
    med = float(np.median(step_ms[2:]))
    tmed = float(np.median(tgt_ms[2:]))
    out = {"steps": DET_STEPS, "batch": DET_B, "anchors": DET_ANCHORS,
           "parameters": n_params, "losses": losses,
           "step_ms_median": med, "step_ms": step_ms,
           "img_s": DET_B / med * 1e3, "max_memory_allocated": peak,
           "multibox_target_ms_median": tmed,
           "multibox_target_share": tmed / med,
           "multibox_target_kernels": n_launch,
           "multibox_target_kernel_ms": kern_ms,
           "k3_launches_per_step": counts["cross_entropy_lse"] / DET_STEPS,
           "k3": k3, "card": card}
    print(f"phase 16 SSD300 train on {card}, default policy, B {DET_B}, "
          f"Adam lr 2e-3: step_ms {med:.3f} (median of the last "
          f"{DET_STEPS - 2}; range {min(step_ms[2:]):.3f}-"
          f"{max(step_ms[2:]):.3f}), {out['img_s']:.1f} img/s, "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; loss "
          f"{losses[0]:.4f} -> mean of the last 5 {tail:.4f}; K3 "
          f"{out['k3_launches_per_step']:.0f} launch a step (the 21-class "
          f"rows, its rows route)", flush=True)
    print(f"  multibox_target: {tmed:.3f} ms a step between CUDA events "
          f"(median; {100 * tmed / med:.1f}% of the step), {n_launch} "
          f"kernels and copies summing {kern_ms:.3f} device ms "
          f"(profiler), no host sync", flush=True)
    return out, net, saved


def det_k3(torch, saved):
    """K3 at the SSD300 class loss's shape: step 0's (DET_B * DET_ANCHORS,
    21) f32 logits (rows of 84 bytes, on the rows route) and class
    targets (-1 for ignored anchors), fused_lse against lse_plain and
    cross_entropy_with_logits against the no_kernels loss at 1e-5
    (:func:`k3_case`), timed with random input sets after the real one so
    that the logits come from device memory, and with the real ones
    alone, L2-resident as the step finds them; beside its byte bound,
    the first design and torch.logsumexp, which it must beat. The row is
    phase 16's, not the kernels line's."""
    c = DET_CLASSES + 1
    x = saved[2].transpose(1, 2).reshape(-1, c).contiguous()
    labels = saved[3][2].reshape(-1).long()
    n = x.shape[0]
    g = torch.Generator(device=x.device)
    g.manual_seed(SEED + 17)
    xs = k3_sets(torch, lambda *shape: torch.randn(*shape, generator=g,
                                                   device=x.device),
                 n, c, torch.float32, x)
    row = k3_case(torch, xs, f"({n}, {c}) f32, SSD300 class loss", "rows",
                  labels, resident=True)
    k3_beats_library(row)
    return row


def det_eval(torch, mx, card, net, saved, dev):
    """Phase 16 (b): step 0's targets and a held-out batch's detections on
    the card against their CPU copies; recall at IoU 0.5 (printed);
    box_nms over one image's 8732 decoded boxes and bipartite_matching
    of its anchors against its ground truths, with no host sync."""
    from mxnet_tpu_torch.base import matmul_precision_scope

    out = {}
    anchors, y, cls_t, tgt = saved
    k = DET_CPU_IMAGES
    want = mx.npx.multibox_target(anchors.cpu(), y[:k].cpu(),
                                  cls_t[:k].cpu(), negative_mining_ratio=3.0)
    diff, bad = target_diffs(torch, [t[:k] for t in tgt], want,
                             anchors, y[:k].cpu())
    err = _max_rel(torch, tgt[0][:k], want[0])
    check(not bad, f"multibox_target: card and CPU differ at {bad}")
    check(err <= DET_EW, f"multibox_target offsets {err:.3e} > {DET_EW}")
    out["target"] = {"differing": len(diff), "loc_err": err}
    print(f"phase 16 multibox_target on the card against the CPU copy "
          f"({k} images): class targets and masks differ at {len(diff)} "
          f"anchors, offsets {err:.3e} of 1 + the largest", flush=True)
    imgs, labels = det_images(DET_B, SEED + 1)
    x = torch.from_numpy(imgs).to(dev)
    with matmul_precision_scope("default"), torch.no_grad():
        anchors, cls_pred, box_pred = net(x)
        probs = mx.npx.softmax(cls_pred, axis=-1).transpose(1, 2)
        probs, box_pred = probs.contiguous(), box_pred.contiguous()
        def detect():
            return mx.npx.multibox_detection(probs, box_pred, anchors,
                                             **DET_THRESH)

        dets, ms = event_ms(torch, detect, guard=True)
        event_ms(torch, detect)
        _, ms2 = event_ms(torch, detect)
        n_launch, kern_ms = profiled_launches(torch, detect)
    want = mx.npx.multibox_detection(probs[:k].cpu(), box_pred[:k].cpu(),
                                     anchors.cpu(), **DET_THRESH)
    diff, bad = detection_diffs(torch, dets[:k], want,
                                DET_THRESH["nms_threshold"])
    # a suppressed row keeps its score and box: those columns agree on
    # every row, whatever the NMS kept
    err = _max_rel(torch, dets[:k, :, 1:], want[:, :, 1:])
    check(not bad, f"multibox_detection: card and CPU differ at (image, "
          f"sorted row) {bad} with no IoU within {DET_NEAR} of the "
          "threshold")
    check(err <= DET_EW, f"multibox_detection values {err:.3e} > {DET_EW}")
    check(tuple(dets.shape) == (DET_B, DET_ANCHORS, 6)
          and torch.isfinite(dets).all().item(), "detections")
    hits, total = 0, 0
    d_host = dets.cpu()
    for i in range(DET_B):
        gt = torch.from_numpy(labels[i][labels[i][:, 0] >= 0])
        kept = d_host[i][d_host[i][:, 0] >= 0]
        total += len(gt)
        if len(kept):
            iou = mx.npx.box_iou(kept[:, 2:6], gt[:, 1:5])
            hits += int((iou.max(0).values >= 0.5).sum())
    n_kept = int((d_host[..., 0] >= 0).sum())
    out["detection"] = {"ms_first": ms, "ms": ms2, "kernels": n_launch,
                        "kernel_ms": kern_ms, "kept": n_kept,
                        "recall_at_0.5": hits / max(total, 1),
                        "differing_images": diff, "value_err": err}
    print(f"phase 16 multibox_detection on {card} (B {DET_B}, "
          f"{DET_THRESH}): {ms2:.3f} ms between CUDA events ({ms:.3f} the "
          f"first call), {n_launch} kernels and copies summing "
          f"{kern_ms:.3f} device ms, no host sync; {n_kept} rows kept; "
          f"against the CPU copy ({k} images) {len(diff)} differ, values "
          f"{err:.3e}; recall at IoU 0.5 {hits}/{total} = "
          f"{hits / max(total, 1):.3f} (printed, not held)", flush=True)
    # box_nms over image 0's decoded boxes, bipartite matching of its
    # anchors against its ground truths
    p = box_pred[0].reshape(-1, 4)
    a = anchors[0]
    aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
    ax, ay = (a[:, 0] + a[:, 2]) * 0.5, (a[:, 1] + a[:, 3]) * 0.5
    ox, oy = p[:, 0] * 0.1 * aw + ax, p[:, 1] * 0.1 * ah + ay
    ow = torch.exp(p[:, 2] * 0.2) * aw / 2
    oh = torch.exp(p[:, 3] * 0.2) * ah / 2
    score, ids = probs[0, 1:].max(0)
    rows = torch.stack([ids.float(), score, ox - ow, oy - oh, ox + ow,
                        oy + oh], 1)
    kept, ms = event_ms(torch, lambda: mx.npx.box_nms(
        rows, overlap_thresh=0.45, valid_thresh=0.01), guard=True)
    want = mx.npx.box_nms(rows.cpu(), overlap_thresh=0.45, valid_thresh=0.01)
    same = torch.equal(kept.cpu(), want)
    if not same:
        # a suppressed row is all -1: the boxes of the sorted rows come
        # from the input, sorted as box_nms sorts them
        rows_c = rows.cpu()
        order = torch.argsort(-rows_c[:, 1], stable=True)
        keep_g, keep_w = kept[:, 1].cpu() >= 0, want[:, 1] >= 0
        both = keep_g & keep_w
        check(torch.equal(kept.cpu()[both], want[both]),
              "box_nms: a row kept on both sides differs")
        _, bad = nms_diffs(torch, "box_nms", keep_g, keep_w,
                           rows_c[order, 2:6], None, 0.45)
        check(not bad, f"box_nms: card and CPU differ at sorted rows {bad} "
              f"with no IoU within {DET_NEAR} of 0.45")
    gt = y[0][y[0][:, 0] >= 0][:, 1:5]
    score_m = mx.npx.box_iou(anchors[0], gt)
    match, bms = event_ms(torch, lambda: mx.npx.bipartite_matching(
        score_m, threshold=1e-12), guard=True)
    want_m = mx.npx.bipartite_matching(score_m.cpu(), threshold=1e-12)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(match, want_m)),
          "bipartite_matching: card and CPU differ")
    out["graphs"] = det_graphs(torch, mx, card, saved, probs, box_pred,
                               anchors, rows, score_m)
    out["box_nms"] = {"rows": rows.shape[0], "ms": ms, "kept": int(
        (kept[:, 0] >= 0).sum()), "equal_cpu": same}
    out["bipartite_matching"] = {"shape": list(score_m.shape), "ms": bms}
    print(f"phase 16 box_nms over {rows.shape[0]} boxes of one image: "
          f"{ms:.3f} ms between CUDA events ({rows.shape[0]} sweep passes), "
          f"{out['box_nms']['kept']} kept, equal to the CPU copy: {same}; "
          f"bipartite_matching over {tuple(score_m.shape)}: {bms:.3f} ms, "
          "equal to the CPU copy; no host sync in either", flush=True)
    return out


def graph_replay(torch, fn):
    """Capture one call of ``fn`` in a torch.cuda.CUDAGraph (after a
    warm-up call on a side stream, as torch's capture asks), replay it
    once and return (the captured outputs, a tuple, after the replay;
    the replay's ms between CUDA events)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    graph.replay()
    _, ms = event_ms(torch, graph.replay)
    return (outs if isinstance(outs, tuple) else (outs,)), ms


def det_graphs(torch, mx, card, saved, probs, box_pred, anchors, rows,
               score_m):
    """The four detection ops, each captured in a CUDA graph and replayed
    on :func:`det_eval`'s inputs: multibox_target (step 0's),
    multibox_detection (the held-out batch), box_nms (image 0's 8732
    decoded boxes) and bipartite_matching (its anchors against its
    ground truths). The replay equals the eager call (class targets,
    masks, kept ids and matches exactly, offsets, scores and boxes to
    DET_EW), so none reads the card on the host; the replay's ms beside
    the eager call's."""
    s_anchors, y, cls_t, _ = saved
    out = {}
    cases = (
        ("box_nms", lambda: mx.npx.box_nms(rows, overlap_thresh=0.45,
                                           valid_thresh=0.01),
         lambda e, g: (torch.equal(e[0][:, 0], g[0][:, 0]),
                       _max_rel(torch, g[0], e[0]))),
        ("bipartite_matching", lambda: mx.npx.bipartite_matching(
            score_m, threshold=1e-12),
         lambda e, g: (torch.equal(e[0], g[0]) and torch.equal(e[1], g[1]),
                       0.0)),
        ("multibox_target", lambda: mx.npx.multibox_target(
            s_anchors, y, cls_t, negative_mining_ratio=3.0),
         lambda e, g: (torch.equal(e[1], g[1]) and torch.equal(e[2], g[2]),
                       _max_rel(torch, g[0], e[0]))),
        ("multibox_detection", lambda: mx.npx.multibox_detection(
            probs, box_pred, anchors, **DET_THRESH),
         lambda e, g: (torch.equal(e[0][..., 0], g[0][..., 0]),
                       _max_rel(torch, g[0][..., 1:], e[0][..., 1:]))))
    for name, fn, held in cases:
        eager, eager_ms = event_ms(torch, fn)
        eager = eager if isinstance(eager, tuple) else (eager,)
        got, ms = graph_replay(torch, fn)
        exact, err = held(eager, got)
        bitwise = all(torch.equal(a, b) for a, b in zip(eager, got))
        check(exact and err <= DET_EW, f"{name}: the CUDA graph's replay "
              f"against the eager call: ids and masks equal {exact}, "
              f"values {err:.3e}")
        out[name] = {"replay_ms": ms, "eager_ms": eager_ms,
                     "value_err": err, "bitwise": bitwise}
        print(f"phase 16 {name} captured in a CUDA graph on {card}: the "
              f"replay {ms:.3f} ms between CUDA events against {eager_ms:.3f}"
              f" eager; ids and masks equal, values {err:.3e} (bitwise "
              f"{bitwise})", flush=True)
        del got
    return out


def _op_case(torch, name, fn, args, cpu_args, tol, grad=None, cpu_fn=None):
    """One detection-model op on the card: device and host ms
    (:func:`time_ms`), held against the same op on CPU copies (a slice
    where each output row depends only on its own inputs); with
    ``grad`` (the indices of the inputs to differentiate) its backward
    too, timed and held alike."""
    with torch.no_grad():
        dev_ms, host_ms = time_ms(lambda i: fn(*args), iters=10, warmup=2)
    row = {"ms": dev_ms, "host_ms": host_ms}
    got = fn(*[a[:c.shape[0]] if slicer else a for a, c, slicer in cpu_args])
    want = (cpu_fn or fn)(*[c for _, c, _ in cpu_args])
    row["err"] = max(_max_rel(torch, g, w) for g, w in zip(
        got if isinstance(got, (list, tuple)) else [got],
        want if isinstance(want, (list, tuple)) else [want]))
    check(row["err"] <= tol, f"{name}: card against CPU {row['err']:.3e} "
          f"> {tol}")
    if grad is not None:
        leaves = [a.detach().requires_grad_(i in grad)
                  for i, a in enumerate(args)]
        y = fn(*leaves)
        g = torch.randn_like(y)
        dx = [leaves[i] for i in grad]
        bwd, _ = time_ms(lambda i: torch.autograd.grad(
            y, dx, g, retain_graph=True), iters=5, warmup=1)
        row["backward_ms"] = bwd
        cl = [(a[:c.shape[0]] if s else a).detach().requires_grad_(i in grad)
              for i, (a, c, s) in enumerate(cpu_args)]
        cc = [c.detach().requires_grad_(i in grad)
              for i, (_, c, _) in enumerate(cpu_args)]
        yg = fn(*cl)
        gy = torch.randn_like(yg)
        got_g = torch.autograd.grad(yg, [cl[i] for i in grad], gy)
        want_g = torch.autograd.grad((cpu_fn or fn)(*cc),
                                     [cc[i] for i in grad], gy.cpu())
        row["grad_err"] = max(_max_rel(torch, a, b)
                              for a, b in zip(got_g, want_g))
        check(row["grad_err"] <= tol, f"{name} gradient: card against CPU "
              f"{row['grad_err']:.3e} > {tol}")
    print(f"  {name}: {dev_ms:.4f} device ms ({host_ms:.4f} host)"
          + (f", backward {row['backward_ms']:.4f}" if grad else "")
          + f"; against the CPU copy {row['err']:.2e}"
          + (f", gradient {row['grad_err']:.2e}" if grad else ""),
          flush=True)
    return row


def _rois(rng, n, batch, width, height):
    """(n, 5) rois [batch, x1, y1, x2, y2] inside a width x height image."""
    w = rng.uniform(16, width / 3, n)
    h = rng.uniform(16, height / 3, n)
    x = rng.uniform(0, width - w)
    y = rng.uniform(0, height - h)
    return np.stack([rng.randint(0, batch, n), x, y, x + w, y + h],
                    1).astype(np.float32)


def det_ops(torch, mx, card, dev):
    """Phase 16 (c): the detection-model ops at published shapes, and the
    control flow, on the card against CPU copies, under highest."""
    from mxnet_tpu_torch.gluon.contrib import cnn
    from mxnet_tpu_torch.convert import from_jax_params

    npx = mx.npx
    rng = np.random.RandomState(SEED + 16)
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def case(name, fn, args, sliced, tol=DET_EW, grad=None, rows=None):
        """``sliced``: per argument, whether the CPU copy takes its first
        ``rows`` rows."""
        cpu_args = []
        for a, s in zip(args, sliced):
            c = a[:rows] if s else a
            cpu_args.append((a, c.cpu(), s))
        out[name] = _op_case(torch, name, fn, args, cpu_args, tol, grad)

    print(f"phase 16 detection-model ops on {card} (highest), each held "
          "against its CPU copy:", flush=True)
    def roi_inputs(spec):
        shape, n, width, height = spec
        return (t(rng.randn(*shape).astype(np.float32)),
                t(_rois(rng, n, shape[0], width, height)))

    # Mask R-CNN's FPN P2 at 800x1333: roi_align with its gradient
    data, rois = roi_inputs(DET_ROI_ALIGN)
    case("roi_align", lambda d, r: npx.roi_align(
        d, r, (7, 7), spatial_scale=0.25, sample_ratio=2, aligned=True),
        [data, rois], [False, True], grad=(0,), rows=DET_CPU_ROIS)
    # Fast R-CNN's VGG16 conv5
    data, rois = roi_inputs(DET_ROI_POOL)
    case("roi_pooling", lambda d, r: npx.roi_pooling(d, r, (7, 7), 1 / 16),
         [data, rois], [False, True], rows=DET_CPU_ROIS)
    # R-FCN's head
    data, rois = roi_inputs(DET_PSROI)
    case("psroi_pooling", lambda d, r: npx.psroi_pooling(
        d, r, 21, 7, 1 / 16), [data, rois], [False, True],
        rows=DET_CPU_ROIS)
    # DCN at ResNet-50 res5 of an 800x1333 input
    nb, c, h, wd = DET_DCN
    data = t(rng.randn(nb, c, h, wd).astype(np.float32))
    off = t((rng.randn(nb, 18, h, wd) * 2).astype(np.float32))
    mask = t(rng.rand(nb, 9, h, wd).astype(np.float32))
    w = t((rng.randn(c, c, 3, 3) * 0.02).astype(np.float32))
    b = t(rng.randn(c).astype(np.float32))
    case("deformable_convolution", lambda d, o, w_, b_:
         npx.deformable_convolution(d, o, w_, b_, kernel=(3, 3), pad=1),
         [data, off, w, b], [True, True, False, False], tol=DET_DEF,
         grad=(0, 1), rows=1)
    case("modulated_deformable_convolution", lambda d, o, m, w_:
         npx.modulated_deformable_convolution(d, o, m, w_, kernel=(3, 3),
                                              pad=1),
         [data, off, mask, w], [True, True, True, False], tol=DET_DEF,
         grad=(0, 1, 2), rows=1)
    blk = cnn.DeformableConvolution(c, 3, padding=1)
    blk.initialize(device=dev)
    with torch.no_grad():
        blk(data)
    from_jax_params({n: (rng.randn(*p.shape) * 0.02).astype(np.float32)
                     for n, p in blk.collect_params().items()}, blk)
    cblk = cnn.DeformableConvolution(c, 3, padding=1)
    cblk.initialize(device="cpu")
    from_jax_params({n: p.data().detach().cpu().numpy()
                     for n, p in blk.collect_params().items()}, cblk)
    out["DeformableConvolution"] = _op_case(
        torch, "DeformableConvolution block", blk, [data],
        [(data, data[:1].cpu(), True)], DET_DEF, cpu_fn=cblk)
    # box ops at SSD's sizes
    x = t(rng.randn(*DET_SSD_MAP).astype(np.float32))
    case("bilinear_resize_2d", lambda d: npx.bilinear_resize_2d(
        d, 2 * x.shape[2], 2 * x.shape[3]), [x], [True], rows=4)
    gamma = t(rng.rand(x.shape[1]).astype(np.float32) + 0.5)
    beta = t(rng.randn(x.shape[1]).astype(np.float32))
    case("sync_batch_norm", lambda d, g, b_: mx.ops.contrib.sync_batch_norm(
        d, g, b_, None, None)[0], [x, gamma, beta], [False] * 3)
    out["control_flow"] = det_control_flow(torch, mx, dev, rng)
    return out


def det_control_flow(torch, mx, dev, rng):
    """foreach over an LSTM-style cell (DET_LSTM) forward and backward,
    held on a CPU copy of its first rows; while_loop and cond on the card
    eagerly and inside a hybridized block's CUDA graph (no host read in
    the capture), against their CPU results."""
    from mxnet_tpu_torch.gluon import HybridBlock

    npx = mx.npx
    u, b, steps = DET_LSTM
    w = torch.from_numpy((rng.randn(2 * u, 4 * u) / math.sqrt(2 * u)
                          ).astype(np.float32))
    xs = torch.from_numpy(rng.randn(steps, b, u).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(b, u).astype(np.float32))

    def run(w_, xs_, h_, c_):
        def body(x, st):
            h, c = st
            z = torch.cat([x, h], 1) @ w_
            i, f, o, g = z.chunk(4, 1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            return h2, [h2, c2]
        outs, (h, c) = npx.foreach(body, xs_, [h_, c_])
        return outs.sum() + (h * c).sum()

    card = [a.to(dev).requires_grad_() for a in (xs, h0, h0 * 0.5)]
    wd = w.to(dev)
    with torch.no_grad():
        fwd, fhost = time_ms(lambda i: run(wd, *card), iters=3, warmup=1)
    loss = run(wd, *card)
    bwd, _ = time_ms(lambda i: torch.autograd.grad(loss, card,
                                                   retain_graph=True),
                     iters=3, warmup=1)
    k = 4
    sl = [a[:, :k] if a.dim() == 3 else a[:k] for a in card]
    sl = [a.detach().requires_grad_() for a in sl]
    got = torch.autograd.grad(run(wd, *sl), sl)
    cp = [a.detach().cpu().requires_grad_() for a in sl]
    want = torch.autograd.grad(run(w, *cp), cp)
    err = max(_max_rel(torch, g, v) for g, v in zip(got, want))
    check(err <= DET_DEF, f"foreach gradients: card against CPU {err:.3e}")
    print(f"  foreach over an LSTM-style cell of {u} units, B {b}, "
          f"{steps} steps: forward {fwd:.3f} device ms ({fhost:.3f} host), "
          f"backward {bwd:.3f}; gradients against the CPU copy ({k} rows) "
          f"{err:.2e}", flush=True)

    class Loop(HybridBlock):
        def forward(self, s):
            acc, (_, fin) = npx.while_loop(
                lambda i, v: i < 6.5, lambda i, v: ([v * 1.5],
                                                    [i + 1, v + 1]),
                [torch.zeros((), device=s.device), s], 10)
            return npx.cond(lambda v: v.sum() > 0, lambda v: v * 10,
                            lambda v: v - 10, [fin]) + acc.sum(0)

    s = torch.from_numpy(rng.randn(64).astype(np.float32))
    want = Loop()(s)
    net = Loop()
    net.initialize(device=dev)
    eager = net(s.to(dev))
    net.hybridize()
    first = net(s.to(dev))
    replay = net(s.to(dev))
    for what, got in (("eager", eager), ("captured", first),
                      ("replayed", replay)):
        check(_max_rel(torch, got, want) <= DET_EW,
              f"while_loop/cond {what} against the CPU")
    neg = net(-s.abs().to(dev) - 20)
    check(_max_rel(torch, neg, Loop()(-s.abs() - 20)) <= DET_EW,
          "cond's else branch replayed")
    check(net.captures >= 1 and net.replays >= 2,
          f"while_loop/cond: {net.captures} graphs captured and "
          f"{net.replays} replays, so the block ran eagerly")
    print(f"  while_loop and cond: eager, captured ({net.captures} graphs) "
          f"and replayed ({net.replays}) equal the CPU's", flush=True)
    return {"foreach_ms": fwd, "foreach_host_ms": fhost,
            "foreach_backward_ms": bwd, "foreach_grad_err": err,
            "captures": net.captures, "replays": net.replays}


def detect_phase(torch, card, wrappers):
    """Phase 16: SSD300 training and decoding (:func:`det_train`,
    :func:`det_eval`), the detection-model ops and the control flow
    (:func:`det_ops`)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import matmul_precision_scope

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    out = {}
    out["train"], net, saved = det_train(torch, mx, card, wrappers, dev)
    out["eval"] = det_eval(torch, mx, card, net, saved, dev)
    del net, saved
    torch.cuda.empty_cache()
    with matmul_precision_scope("highest"):
        out["ops"] = det_ops(torch, mx, card, dev)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 16 took {out['seconds']:.1f} s on {card}", flush=True)
    return out


# -- phase 17: the flagship example's data loop ------------------------------
# example/gluon/image_classification_torch.py (the port's copy of
# example/gluon/image_classification.py) at its defaults: resnet18_v1 at
# 32x32, 10 classes, B 64, hybridized, SGD lr 0.05 momentum 0.9 wd 1e-4,
# one epoch of get_data's synthetic ArrayDataset (20 batches) and of the
# synthetic CIFAR10(train=True) through transform_first(ToTensor()), then
# evaluate() with metric.Accuracy, without and with amp.init()
DATA_EXAMPLE = ["--model", "resnet18_v1", "--batch-size", "64"]
# ResNet-50 v1 at full width through gluon.data: a seeded uint8 HWC
# dataset of 8 batches (256 images, 38.5 MB) under Compose([ToTensor(),
# Normalize(ImageNet mean, std)]), phase 9's B 32 at 224x224, SGD lr 0.05
# momentum 0.9 wd 1e-4, under default; each loader configuration trains
# one epoch from the same weights and zeroed momentum
DATA_BATCHES = 8
DATA_MEAN, DATA_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
DATA_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
DATA_LOADERS = [("0 workers", {}), ("4 fork workers", {"num_workers": 4}),
                ("4 threads", {"num_workers": 4, "thread_pool": True})]
# the card's bf16 AMP step against the port's CPU copy of it: the mean
# loss, relative. bf16 keeps 8 bits, and the card's cuDNN and the CPU's
# oneDNN round each of resnet18_v1's 21 products in another order:
# sound runs read 2.1e-3 to 2.3e-3. A step run in another precision
# reads about as close (the printed control: the card without AMP), so
# this limit catches gross faults; the dtypes each op is handed, logged
# on both sides, catch a precision fault
DATA_AMP_TOL = 1e-2
# ImageRecordIter's records: 64 .npy payloads at 224x224x3, B 32
DATA_REC_N = 64
# a longer epoch (the 256 images four times, 32 batches) for each
# loader's steady state, where 8 batches in flight are no longer the
# whole epoch
DATA_LONG_REPEAT = 4


def data_example_module():
    """example/gluon/image_classification_torch.py as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "example", "gluon", "image_classification_torch.py")
    spec = importlib.util.spec_from_file_location("ic_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data_example(torch, card, wrappers):
    """Phase 17(a): the example's own loop at its defaults, through its
    build, get_data, train_epoch and evaluate, on the synthetic
    ArrayDataset and the synthetic CIFAR-10, without and with AMP: K3
    once a step and nothing else of the port, a finite loss, and under
    AMP every convolution and the classifier in bfloat16 and K3's input
    in float32."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    ex = data_example_module()
    out = {}
    for use_amp in (False, True):
        for dataset in ("synthetic", "cifar10"):
            args = ex.parse_args(DATA_EXAMPLE + ["--dataset", dataset]
                                 + (["--amp"] if use_amp else []))
            np.random.seed(SEED)
            net, trainer, loss_fn = ex.build(args)
            loader, val_loader = ex.get_data(args)
            seen = data_dtype_spy(torch, net, nn, kce)
            try:
                for w in wrappers.values():
                    w.launches = 0
                loss, n, secs = ex.train_epoch(net, trainer, loss_fn, loader)
                counts = {k: w.launches for k, w in wrappers.items()}
                acc = ex.evaluate(net, val_loader)
            finally:
                loader.close()
                val_loader.close()
                data_spy_off(seen, kce)
                amp.disable()
            steps = n // args.batch_size
            want = dict({k: 0 for k in wrappers}, cross_entropy_lse=steps)
            label = f"{dataset}{' amp' if use_amp else ''}"
            check(counts == want, f"17(a) {label}: launches {counts}")
            check(math.isfinite(loss), f"17(a) {label}: loss {loss}")
            data_check_dtypes(torch, seen, use_amp, f"17(a) {label}")
            out[label] = {"loss": loss, "val_acc": acc, "images": n,
                          "img_s": n / secs, "k3": counts["cross_entropy_lse"],
                          "dtypes": seen["dtypes"]}
            print(f"phase 17(a) example defaults (resnet18_v1 32x32, B 64, "
                  f"hybridized, SGD) on {card}, {label}: one epoch of "
                  f"{steps} steps, loss {loss:.4f}, val_acc {acc:.4f}, "
                  f"{n / secs:.1f} img/s (a loss read each step), K3 "
                  f"launches {counts['cross_entropy_lse']} (= steps), "
                  f"dtypes {seen['dtypes']}", flush=True)
            del net, trainer
    return out


def data_dtype_spy(torch, net, nn, kce):
    """Record the output dtype of every Conv2D and Dense of ``net`` (their
    forward hooks, which run in a capture's warm-up) and K3's input
    dtype (a stand-in for ``kce._nll``, which takes the logits K3 took
    and calls the original); :func:`data_spy_off` undoes both."""
    seen = {"dtypes": {}, "orig": kce._nll}

    def hook(block, args, out):
        kind = "conv" if isinstance(block, nn.Conv2D) else "dense"
        seen["dtypes"].setdefault(kind, set()).add(str(out.dtype)[6:])

    seen["hooks"] = [m.register_forward_hook(hook) for m in net.modules()
                     if isinstance(m, (nn.Conv2D, nn.Dense))]
    orig = kce._nll

    def spy(logits, lab, lse):
        seen["dtypes"].setdefault("k3", set()).add(str(logits.dtype)[6:])
        return orig(logits, lab, lse)

    kce._nll = spy
    return seen


def data_spy_off(seen, kce):
    kce._nll = seen["orig"]
    for h in seen["hooks"]:
        h.detach()


def data_check_dtypes(torch, seen, use_amp, label):
    d = seen["dtypes"]
    act = {"bfloat16"} if use_amp else {"float32"}
    check(d.get("conv") == act and d.get("dense") == act
          and d.get("k3") == {"float32"},
          f"{label}: dtypes {d}, expected convolutions and dense {act}, "
          f"K3 float32")
    seen["dtypes"] = {k: sorted(v) for k, v in d.items()}


def data_zero_states(torch, state):
    if isinstance(state, torch.Tensor):
        state.zero_()
    elif isinstance(state, (tuple, list)):
        for s in state:
            data_zero_states(torch, s)


# the forked pool's timeline: per job (slot job % 64), the times
# (perf_counter, CLOCK_MONOTONIC, one clock for every process) at which a
# worker took the task, finished it, had pickled the result, held the
# result pipe's write lock, and had written it; then the parent's result
# thread had read its bytes and unpickled it. A shared anonymous mapping
# made before the fork carries the workers' times to the parent.
_TL = {}
_TL_COLS = ("taken", "computed", "pickled", "locked", "sent", "read",
            "unpickled", "pid")


def _tl_get(self):
    task = _TL["get"](self)
    if os.getpid() != _TL["parent"] and isinstance(task, tuple) \
            and len(task) == 5:
        _TL["rows"][task[0] % 64, 0] = time.perf_counter()
    return task


def _tl_put(self, obj):
    if os.getpid() == _TL["parent"] or not (isinstance(obj, tuple)
                                            and len(obj) == 3):
        return _TL["put"](self, obj)
    from multiprocessing.reduction import ForkingPickler

    row = _TL["rows"][obj[0] % 64]
    row[1] = time.perf_counter()
    buf = ForkingPickler.dumps(obj)
    row[2] = time.perf_counter()
    with self._wlock:
        row[3] = time.perf_counter()
        self._writer.send_bytes(buf)
        row[4] = time.perf_counter()
    row[7] = os.getpid()


def _tl_recv(self):
    from multiprocessing.reduction import ForkingPickler

    self._check_closed()
    self._check_readable()
    buf = self._recv_bytes()
    t_read = time.perf_counter()
    obj = ForkingPickler.loads(buf.getbuffer())
    if os.getpid() == _TL["parent"] and isinstance(obj, tuple) \
            and len(obj) == 3 and isinstance(obj[0], int):
        row = _TL["rows"][obj[0] % 64]
        row[5], row[6] = t_read, time.perf_counter()
    return obj


def data_long_epochs(torch, card, trainer, restore, run, base_ms,
                     base_img_s, make_loader):
    """Phase 17(b), the loaders' steady state: each of DATA_LOADERS
    (pin_memory off, AMP off) reads the long epoch (DATA_LONG_REPEAT
    times the dataset) alone and then trains it; the loader's share of
    the epoch against the resident epoch's img/s, and of the median
    step against the resident median step."""
    out = []
    base_med = float(np.median(base_ms))
    for label, kw in DATA_LOADERS:
        restore(trainer)
        np.random.seed(SEED)
        loader = make_loader(**kw)
        try:
            got = [b for b in loader]
            n = len(got)
            del got
            np.random.seed(SEED)
            steps, losses, wall = run(trainer, loader)
        finally:
            loader.close()
        lv = torch.stack(losses).float()
        check(len(steps) == n == DATA_BATCHES * DATA_LONG_REPEAT
              and bool(torch.isfinite(lv).all()),
              f"17(b) long epoch, {label}: {len(steps)} steps of {n}, "
              f"loss {lv.tolist()}")
        img_s = RN_B * len(steps) / wall
        med = float(np.median(steps))
        row = {"loader": label, "steps": len(steps), "img_s": img_s,
               "step_ms_median": med, "step_ms_first": steps[0],
               "step_ms_max_after_first": max(steps[1:]),
               "loader_share": 1 - img_s / base_img_s,
               "loader_share_median": 1 - base_med / med}
        out.append(row)
        print(f"phase 17(b) long epoch ({len(steps)} steps, AMP off, "
              f"pin_memory False) on {card}, {label}: {img_s:.1f} img/s "
              f"against {base_img_s:.1f} fed from the card (the loader's "
              f"share {row['loader_share']:.3f} of the epoch); step ms "
              f"median {med:.2f} against {base_med:.2f} fed from the card "
              f"(share {row['loader_share_median']:.3f}); first step "
              f"{steps[0]:.2f}, the slowest after it "
              f"{row['step_ms_max_after_first']:.2f}", flush=True)
    return out


def data_pool_timeline(torch, card, make_loader, run, resident):
    """Phase 17(b), the forked pool's first-step wait: one loader of 4
    fork workers (pin_memory off) reads its epoch alone and then trains
    one, as the configurations do, with SimpleQueue's get and put and
    the result pipe's recv timed (:data:`_TL`) and the loader's upload
    too; returns the trained epoch's timeline, batch by batch, in ms
    from the start of its ``iter()``. Then the steps over the batches
    already on the card, without a fork and right after a loader forks
    4 idle workers: what a fork alone costs the steps after it."""
    import mmap
    import multiprocessing.connection as mpc
    import multiprocessing.queues as mpq

    from mxnet_tpu_torch.gluon.data import dataloader as dlm

    mm = mmap.mmap(-1, 64 * len(_TL_COLS) * 8)     # MAP_SHARED
    _TL.update(parent=os.getpid(), get=mpq.SimpleQueue.get,
               put=mpq.SimpleQueue.put, recv=mpc.Connection.recv,
               upload=dlm._upload,
               rows=np.frombuffer(mm, np.float64).reshape(64, -1))
    uploads = []

    def upload(*a):
        t0 = time.perf_counter()
        out = _TL["upload"](*a)
        uploads.append((t0, time.perf_counter()))
        return out

    mpq.SimpleQueue.get, mpq.SimpleQueue.put = _tl_get, _tl_put
    mpc.Connection.recv = _tl_recv
    dlm._upload = upload
    try:
        loader = make_loader()          # forks the pool: after the patches
        try:
            got = [b for b in loader]
            del got
            _TL["rows"][:] = 0
            uploads.clear()
            np.random.seed(SEED)
            t_iter = time.perf_counter()
            it = iter(loader)
            t_disp = time.perf_counter()
            jobs = [it._pending[k]._job for k in sorted(it._pending)]
            steps, _, wall = run(it)
        finally:
            loader.close()
        rows = _TL["rows"][[j % 64 for j in jobs]].copy()
    finally:
        mpq.SimpleQueue.get, mpq.SimpleQueue.put = _TL["get"], _TL["put"]
        mpc.Connection.recv = _TL["recv"]
        dlm._upload = _TL["upload"]
        del _TL["rows"]
        mm.close()
    check(len(uploads) == len(jobs) == len(steps) and bool((rows[:, :7]
                                                            > 0).all()),
          f"17(b) pool timeline: {len(jobs)} jobs, {len(uploads)} uploads, "
          f"{len(steps)} steps, rows {rows.tolist()}")
    ms = lambda t: 1e3 * (t - t_iter)           # noqa: E731
    out = {"dispatch_ms": ms(t_disp), "wall_ms": 1e3 * wall, "batches": []}
    step_end = np.cumsum(steps)
    for k, (row, (u0, u1)) in enumerate(zip(rows, uploads)):
        b = {c: float(ms(row[i])) for i, c in enumerate(_TL_COLS[:7])}
        b.update(pid=int(row[7]), got=ms(u0), uploaded=ms(u1),
                 step_end=float(step_end[k]))
        out["batches"].append(b)
    order = sorted(range(len(rows)), key=lambda k: rows[k, 5])
    out["arrival_order"] = order
    d = out["batches"]
    for key, end, start in (("compute_ms", "computed", "taken"),
                            ("pickle_ms", "pickled", "computed"),
                            ("lock_wait_ms", "locked", "pickled"),
                            ("send_ms", "sent", "locked"),
                            ("unpickle_ms", "unpickled", "read"),
                            ("upload_ms", "uploaded", "got")):
        out[key] = [float(b[end] - b[start]) for b in d]
    print(f"phase 17(b) 4 fork workers' timeline on {card} (ms from "
          f"iter(); the 8 tasks dispatched in {out['dispatch_ms']:.2f}):",
          flush=True)
    for k, b in enumerate(d):
        print(f"  batch {k} (pid {b['pid']}): taken {b['taken']:.1f}, "
              f"computed {b['computed']:.1f}, pickled {b['pickled']:.1f}, "
              f"pipe lock held {b['locked']:.1f}, sent {b['sent']:.1f}; "
              f"parent read {b['read']:.1f}, unpickled "
              f"{b['unpickled']:.1f}, handed out {b['got']:.1f}, uploaded "
              f"{b['uploaded']:.1f}; its step ended {b['step_end']:.1f}",
              flush=True)
    print(f"  per batch: compute ms {[round(v, 1) for v in out['compute_ms']]}"
          f"; pickle {[round(v, 1) for v in out['pickle_ms']]}; wait for "
          f"the pipe's lock {[round(v, 1) for v in out['lock_wait_ms']]}; "
          f"write to the pipe {[round(v, 1) for v in out['send_ms']]}; "
          f"unpickle {[round(v, 1) for v in out['unpickle_ms']]}; upload "
          f"{[round(v, 1) for v in out['upload_ms']]}; results arrived in "
          f"the order {order}", flush=True)
    out["resident_no_fork_ms"] = run(resident)[0]
    loader = make_loader()
    try:
        out["resident_after_fork_ms"] = run(resident)[0]
    finally:
        loader.close()
    for label, key in (("without a fork", "resident_no_fork_ms"),
                       ("right after a loader forked 4 idle workers",
                        "resident_after_fork_ms")):
        print(f"  fed from the card, {label}: step ms "
              f"{[round(v, 2) for v in out[key]]}", flush=True)
    return out


def data_resnet(torch, card, wrappers):
    """Phase 17(b): ResNet-50 v1 hybridized at B 32, 224x224, under
    ``default``, fed by ``gluon.data.DataLoader(shuffle=True,
    last_batch="discard")`` over the seeded uint8 dataset (DATA_*), with
    0 workers, 4 fork workers and 4 threads, each with ``pin_memory``
    off and on, without and with AMP; each configuration one epoch from
    the same weights and zeroed momentum. Per configuration: the
    loader's host ms a batch alone, step ms (host wall to a synchronise;
    median and range), img/s through the loader against the same steps
    fed from batches already on the card, peak allocated memory (the
    graph pools are not allocations of the step) and the memory
    reserved, pools included, K3 launches equal
    to the steps, the first convolution's and K3's input dtypes, and a
    finite loss; per pinning, the upload's MB/s."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.base import matmul_precision_scope
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.data.dataloader import _upload
    from mxnet_tpu_torch.gluon.data.vision import transforms
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops.kernels import cross_entropy as kce

    dev = mx.context.resolve_device(None)
    rng = np.random.default_rng(SEED + 17)
    n_img = DATA_BATCHES * RN_B
    imgs = rng.integers(0, 256, (n_img, RN_HW, RN_HW, 3), dtype=np.uint8)
    labels = rng.integers(0, RN_CLASSES, n_img).astype(np.int32)
    tf = transforms.Compose(
        [transforms.ToTensor(), transforms.Normalize(DATA_MEAN, DATA_STD)])
    ds = ArrayDataset(imgs, labels).transform_first(tf)
    ds_long = ArrayDataset(
        np.concatenate([imgs] * DATA_LONG_REPEAT),
        np.concatenate([labels] * DATA_LONG_REPEAT)).transform_first(tf)
    net = vision.get_model("resnet50_v1", classes=RN_CLASSES)
    net.initialize()
    with autograd.pause():
        net(torch.zeros(1, 3, RN_HW, RN_HW, device=dev))
    from_jax_params(resnet_weights(net, SEED), net)
    init = gt_snapshot(net)
    params = net.collect_params()
    net.hybridize()
    loss_fn = SoftmaxCrossEntropyLoss()
    # the batches of one epoch, already on the card: the loader's
    # yardstick; and one host batch for the upload's rate
    np.random.seed(SEED)
    resident = [(x.clone(), y.clone()) for x, y in DataLoader(
        ds, batch_size=RN_B, shuffle=True, last_batch="discard")]
    host = np.stack([ds[i][0] for i in range(RN_B)])
    out = {"card": card, "batch": RN_B, "policy": "default",
           "dataset_mb": imgs.nbytes / 1e6, "upload": {}, "configs": []}
    batch_mb = host.nbytes / 1e6
    for pin in (False, True):
        _upload(host, dev, pin)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            _upload(host, dev, pin)
        torch.cuda.synchronize()
        rate = 8 * batch_mb / (time.perf_counter() - t0)
        out["upload"]["pinned" if pin else "pageable"] = rate
    print(f"phase 17(b) upload of one {host.shape} float32 batch "
          f"({batch_mb:.1f} MB) on {card}: pageable "
          f"{out['upload']['pageable']:.1f} MB/s, pinned (a copy into "
          f"pinned memory and a non_blocking copy) "
          f"{out['upload']['pinned']:.1f} MB/s", flush=True)

    def restore(trainer):
        with torch.no_grad():
            for n, p in params.items():
                p.data().copy_(init[n])
        data_zero_states(torch, list(trainer._states.values()))

    def run(trainer, batches):
        """One epoch: (step ms list, losses, wall s)."""
        steps, losses = [], []
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        t0 = t_start
        for x, y in batches:
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(RN_B)
            losses.append(loss.detach())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            steps.append(1e3 * (t1 - t0))
            t0 = t1
        return steps, losses, time.perf_counter() - t_start

    with matmul_precision_scope("default"):
        for use_amp in (False, True):
            if use_amp:
                amp.init()
            seen = data_dtype_spy(torch, net, nn, kce)
            try:
                trainer = Trainer(params, "sgd", DATA_SGD)
                # capture the pair and the update, cuDNN's set-up
                run(trainer, resident[:2])
                restore(trainer)
                base_ms, _, base_s = run(trainer, resident)
                base_img_s = RN_B * len(resident) / base_s
                for label, kw in DATA_LOADERS:
                    for pin in (False, True):
                        restore(trainer)
                        np.random.seed(SEED)
                        loader = DataLoader(ds, batch_size=RN_B, shuffle=True,
                                            last_batch="discard",
                                            pin_memory=pin, **kw)
                        try:
                            t0 = time.perf_counter()
                            got = [b for b in loader]
                            torch.cuda.synchronize()
                            loader_ms = 1e3 * (time.perf_counter() - t0) \
                                / len(got)
                            del got
                            torch.cuda.reset_peak_memory_stats()
                            for w in wrappers.values():
                                w.launches = 0
                            np.random.seed(SEED)      # the resident order
                            steps, losses, wall = run(trainer, loader)
                            counts = {k: w.launches
                                      for k, w in wrappers.items()}
                        finally:
                            loader.close()
                        # allocated memory counts the tensors the step
                        # makes outside its graphs' pools; reserved, the
                        # pools of the captured pairs too
                        peak = torch.cuda.max_memory_allocated() / 2 ** 30
                        reserved = torch.cuda.memory_reserved() / 2 ** 30
                        name = (f"{label}, pin_memory {pin}, AMP "
                                f"{'on' if use_amp else 'off'}")
                        want = dict({k: 0 for k in wrappers},
                                    cross_entropy_lse=DATA_BATCHES)
                        check(len(steps) == DATA_BATCHES and counts == want,
                              f"17(b) {name}: {len(steps)} steps, launches "
                              f"{counts}")
                        lv = torch.stack(losses).float()
                        check(bool(torch.isfinite(lv).all()),
                              f"17(b) {name}: loss {lv.tolist()}")
                        img_s = RN_B * len(steps) / wall
                        med = float(np.median(steps))
                        row = {"loader": label, "pin_memory": pin,
                               "amp": use_amp, "loader_ms": loader_ms,
                               "step_ms_median": med,
                               "step_ms": steps, "img_s": img_s,
                               "resident_img_s": base_img_s,
                               "loader_share": 1 - img_s / base_img_s,
                               "loader_share_median":
                                   1 - float(np.median(base_ms)) / med,
                               "peak_gib": peak, "reserved_gib": reserved,
                               "k3": counts["cross_entropy_lse"],
                               "loss": lv.mean().item()}
                        out["configs"].append(row)
                        print(f"phase 17(b) resnet50_v1 B 32 224x224 on "
                              f"{card}, {name}: loader alone "
                              f"{loader_ms:.2f} host ms a batch; step ms "
                              f"median {row['step_ms_median']:.2f} (range "
                              f"{min(steps):.2f}-{max(steps):.2f}); "
                              f"{img_s:.1f} img/s through the loader against "
                              f"{base_img_s:.1f} fed from the card (the "
                              f"loader's share {row['loader_share']:.3f} of "
                              f"the epoch, "
                              f"{row['loader_share_median']:.3f} of the "
                              f"median step); "
                              f"peak allocated {peak:.3f} GiB, reserved "
                              f"{reserved:.3f} GiB; K3 launches "
                              f"{row['k3']} of {len(steps)} steps; mean loss "
                              f"{row['loss']:.4f}", flush=True)
                if not use_amp:
                    out["long"] = data_long_epochs(
                        torch, card, trainer, restore, run, base_ms,
                        base_img_s, lambda **kw: DataLoader(
                            ds_long, batch_size=RN_B, shuffle=True,
                            last_batch="discard", **kw))
                    restore(trainer)
                    out["pool_timeline"] = data_pool_timeline(
                        torch, card, lambda: DataLoader(
                            ds, batch_size=RN_B, shuffle=True,
                            last_batch="discard", num_workers=4),
                        lambda batches: run(trainer, batches), resident)
            finally:
                data_spy_off(seen, kce)
                amp.disable()
            data_check_dtypes(torch, seen, use_amp,
                              f"17(b) AMP {'on' if use_amp else 'off'}")
            out[f"dtypes_amp_{'on' if use_amp else 'off'}"] = seen["dtypes"]
            out[f"resident_ms_amp_{'on' if use_amp else 'off'}"] = base_ms
            print(f"phase 17(b) AMP {'on' if use_amp else 'off'}: dtypes "
                  f"{seen['dtypes']}; fed from the card, step ms "
                  f"{[round(v, 2) for v in base_ms]}", flush=True)
    out["captures"] = net.captures
    del net, resident
    torch.cuda.empty_cache()
    return out


def data_amp_cpu(torch, card):
    """Phase 17(c): the card's AMP step against the port's CPU copy of it
    (resnet18_v1 at the example's 32x32, 10 classes, B 64; the same
    weights and batch; eager): the mean loss within DATA_AMP_TOL, beside
    the control (the card's step without AMP against the CPU's AMP
    step), and the sequence of (op name, decided dtype, dtypes of the
    float tensors the op is handed) identical, each op handed its
    decided dtype only. Then a hybridized
    net captures a new graph pair after ``amp.init()`` and replays it in
    bfloat16, and the f32 pair again after ``disable()``; and a float16
    ``init_trainer`` step with an inf gradient leaves the weights bitwise
    unchanged and halves the scale."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import dispatch

    dev = mx.context.resolve_device(None)
    rng = np.random.default_rng(SEED + 18)
    xh = rng.random((64, 3, 32, 32), dtype=np.float32)
    yh = rng.integers(0, 10, 64)
    nets, res = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        net = vision.resnet18_v1(classes=10)
        net.initialize(device=where)
        with autograd.pause():
            net(torch.from_numpy(xh[:1]).to(where))
        if label == "card":
            weights = {n: p.data().detach().cpu()
                       for n, p in net.collect_params().items()}
        else:
            with torch.no_grad():
                for n, p in net.collect_params().items():
                    p.data().copy_(weights[n])
        nets[label] = net
        if label == "card":
            # the control: the card's step without AMP, against the
            # CPU's AMP step below
            with autograd.record():
                ctl = SoftmaxCrossEntropyLoss()(
                    net(torch.from_numpy(xh).to(where)),
                    torch.from_numpy(yh).to(where)).float().mean().item()
        amp.init()
        log = []
        pol = dispatch.amp_policy
        orig = pol.cast_inputs

        def cast_inputs(name, vals, pol=pol, orig=orig, log=log):
            # the decision, and the dtypes of the float tensors the
            # policy actually hands the op
            want = pol.decide(name)
            out = orig(name, vals)
            if want is not None:
                log.append((name, str(want)[6:], tuple(sorted(
                    {str(v.dtype)[6:] for v in out
                     if isinstance(v, torch.Tensor)
                     and v.is_floating_point()}))))
            return out

        pol.cast_inputs = cast_inputs
        try:
            with autograd.record():
                logits = net(torch.from_numpy(xh).to(where))
                loss = SoftmaxCrossEntropyLoss()(
                    logits, torch.from_numpy(yh).to(where))
            autograd.backward(loss)
        finally:
            amp.disable()
        res[label] = (loss.float().mean().item(), log, logits.dtype)
    (lc, logc, dtc), (lh, logh, dth) = res["card"], res["cpu"]
    rel = abs(lc - lh) / abs(lh)
    rel_ctl = abs(ctl - lh) / abs(lh)
    check(rel <= DATA_AMP_TOL, f"17(c) AMP loss card {lc} against CPU {lh}")
    check(logc == logh and len(logc) > 0,
          f"17(c) cast decisions differ: {logc[:6]} against {logh[:6]}")
    unfaithful = [e for e in logc if e[2] not in ((), (e[1],))]
    check(not unfaithful, f"17(c) ops handed other dtypes than decided: "
          f"{unfaithful[:6]}")
    check(dtc == dth == torch.bfloat16, f"17(c) logits {dtc}, {dth}")
    kinds = {n: d for n, d, _ in logc}
    print(f"phase 17(c) AMP step on {card} against the port on the CPU "
          f"(resnet18_v1 32x32, B 64, same weights and batch): mean loss "
          f"{lc:.6f} against {lh:.6f}, {rel:.3e} apart (limit "
          f"{DATA_AMP_TOL:g}); the control, the card's step without AMP, "
          f"{ctl:.6f}: {rel_ctl:.3e} from the CPU's AMP step; "
          f"{len(logc)} cast decisions identical in order, each op handed "
          f"float tensors of its decided dtype only ({kinds}); logits "
          f"bfloat16", flush=True)
    out = {"loss_card": lc, "loss_cpu": lh, "rel": rel,
           "loss_card_amp_off": ctl, "rel_control": rel_ctl,
           "decisions": len(logc)}

    # graphs: a pair per policy version
    net = nets["card"]
    net.hybridize()
    x, y = torch.from_numpy(xh).to(dev), torch.from_numpy(yh).to(dev)
    loss_fn = SoftmaxCrossEntropyLoss()

    def step():
        with autograd.record():
            lg = net(x)
            loss = loss_fn(lg, y)
        autograd.backward(loss)
        return lg.dtype

    seq = [(step(), net.captures, net.replays)]
    amp.init()
    try:
        seq.append((step(), net.captures, net.replays))
        seq.append((step(), net.captures, net.replays))
    finally:
        amp.disable()
    seq.append((step(), net.captures, net.replays))
    (d0, c0, r0), (d1, c1, r1), (d2, c2, r2), (d3, c3, r3) = seq
    check(d0 == d3 == torch.float32 and d1 == d2 == torch.bfloat16,
          f"17(c) hybridized dtypes {d0}, {d1}, {d2}, {d3}")
    check(c1 == c0 + 1 and c2 == c1 and r2 == r1 + 1 and c3 == c2
          and r3 == r2 + 1,
          f"17(c) graphs around amp.init(): captures {c0}, {c1}, {c2}, "
          f"{c3}; replays {r0}, {r1}, {r2}, {r3}")
    print(f"phase 17(c) hybridized resnet18_v1 on {card}: a recorded step "
          f"captured {c0} pair(s) in float32; after amp.init() the next "
          f"captured a new pair ({c1}) with bfloat16 logits and the one "
          f"after replayed it ({r1} -> {r2} replays, no capture); after "
          f"disable() the float32 pair replayed ({c3} captures)", flush=True)
    out["captures"] = [c0, c1, c2, c3]

    # float16 loss scaling: an overflow skips the update
    amp.init("float16")
    try:
        trainer = Trainer(net.collect_params(), "sgd", DATA_SGD)
        amp.init_trainer(trainer, init_scale=1024.0)
        with autograd.record():
            loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as scaled:
                autograd.backward(scaled)
        live = [p.data() for p in net.collect_params().values()
                if p.grad_req != "null"]
        before = [w.detach().clone() for w in live]
        live[0].grad.view(-1)[0] = float("inf")
        trainer.step(64)
        same = all(torch.equal(w, b) for w, b in zip(live, before))
        scale = trainer._amp_loss_scaler.loss_scale
        with autograd.record():
            loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as scaled:
                autograd.backward(scaled)
        trainer.step(64)
        moved = not all(torch.equal(w, b) for w, b in zip(live, before))
    finally:
        amp.disable()
    check(same and scale == 512.0 and moved,
          f"17(c) float16 overflow: weights unchanged {same}, scale {scale}, "
          f"the clean step moved them {moved}")
    print(f"phase 17(c) float16 init_trainer on {card}: an inf gradient "
          f"skipped the update (all {len(live)} weights bitwise unchanged), "
          f"scale 1024 -> {scale:g}; the next clean step updated", flush=True)
    out["fp16_scale_after_overflow"] = scale
    return out


def data_io(torch, card):
    """Phase 17(d): ImageRecordIter over a .rec of DATA_REC_N .npy records
    at 224x224 (B 32) that the phase writes, NDArrayIter over the same
    images (shuffled under one numpy seed) and PrefetchingIter around it,
    on the card and on the CPU: every batch bitwise equal, MB/s of
    float32 data through each on the card."""
    import shutil

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import io, recordio

    dev = mx.context.resolve_device(None)
    rng = np.random.default_rng(SEED + 19)
    imgs = rng.integers(0, 256, (DATA_REC_N, RN_HW, RN_HW, 3), dtype=np.uint8)
    labels = rng.integers(0, RN_CLASSES, DATA_REC_N).astype(np.float32)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mxnet_tpu_torch", "_build", "chip_smoke_io")
    os.makedirs(root, exist_ok=True)
    rec = os.path.join(root, "imgs.rec")
    out = {}
    try:
        w = recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "w")
        for i in range(DATA_REC_N):
            w.write_idx(i, recordio.pack_img(
                recordio.IRHeader(0, float(labels[i]), i, 0), imgs[i],
                img_fmt=".npy"))
        w.close()
        # an iterator fixes its device, the caller's scope, when made
        makers = {
            "ImageRecordIter": lambda: io.ImageRecordIter(
                rec, RN_B, (3, RN_HW, RN_HW)),
            "NDArrayIter": lambda: io.NDArrayIter(
                imgs.transpose(0, 3, 1, 2).astype(np.float32), labels,
                batch_size=RN_B, shuffle=True),
            "PrefetchingIter": lambda: io.PrefetchingIter(io.NDArrayIter(
                imgs.transpose(0, 3, 1, 2).astype(np.float32), labels,
                batch_size=RN_B, shuffle=True))}
        for name, make in makers.items():
            got = {}
            for label, scope in (("card", mx.gpu(dev.index)),
                                 ("cpu", mx.cpu())):
                np.random.seed(SEED)
                with scope:
                    it = make()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[label] = [(b.data[0], b.label[0], b.pad) for b in it]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if label == "card":
                    mb = sum(x.numel() * x.element_size()
                             for x, _, _ in got[label]) / 1e6
                    out[name] = {"mb_s": mb / secs,
                                 "batches": len(got[label])}
                if hasattr(it, "close"):
                    it.close()
            same = len(got["card"]) == len(got["cpu"]) == \
                DATA_REC_N // RN_B and all(
                    torch.equal(a.cpu(), c) and torch.equal(la.cpu(), lc)
                    and pa == pc and a.is_cuda
                    for (a, la, pa), (c, lc, pc) in zip(got["card"],
                                                        got["cpu"]))
            check(same, f"17(d) {name}: the card's batches differ from the "
                  "CPU's")
            print(f"phase 17(d) {name} on {card}: {len(got['card'])} "
                  f"batches of {tuple(got['card'][0][0].shape)} float32 "
                  f"bitwise equal to "
                  f"the CPU's, {out[name]['mb_s']:.1f} MB/s to the card",
                  flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def data_phase(torch, card, wrappers):
    """Phase 17: the flagship example's data loop on the card
    (:func:`data_example`, :func:`data_resnet`, :func:`data_amp_cpu`,
    :func:`data_io`)."""
    t_phase = time.perf_counter()
    home = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "mxnet_tpu_torch", "_build", "chip_smoke_home")
    os.makedirs(home, exist_ok=True)
    old_home = os.environ.get("MXNET_HOME")
    os.environ["MXNET_HOME"] = home       # empty: the synthetic datasets
    try:
        out = {"example": data_example(torch, card, wrappers)}
    finally:
        if old_home is None:
            del os.environ["MXNET_HOME"]
        else:
            os.environ["MXNET_HOME"] = old_home
        os.rmdir(home)
    torch.cuda.empty_cache()
    out["resnet"] = data_resnet(torch, card, wrappers)
    torch.cuda.empty_cache()
    out["amp_cpu"] = data_amp_cpu(torch, card)
    torch.cuda.empty_cache()
    out["io"] = data_io(torch, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17 took {out['seconds']:.1f} s on {card}", flush=True)
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    opts = dict(a[2:].split("=", 1) for a in argv
                if a.startswith(("--serve-one=", "--serve-ab=", "--rounds=")))
    rounds = int(opts.get("rounds", 20))
    if "serve-one" in opts:      # one engine's run of serve_ab: no result
        return serve_one(opts["serve-one"], rounds)
    if "serve-ab" in opts:       # phase 3's workload per tree: no result
        return serve_ab(opts["serve-ab"].split(","), rounds, card_line())
    from mxnet_tpu_torch.base import (matmul_precision,
                                      matmul_precision_scope,
                                      set_matmul_precision)
    from mxnet_tpu_torch.convert import from_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import gpt_like
    from mxnet_tpu_torch.gluon.model_zoo.generation import (
        generate, paged_decode_program)
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.serving.llm import LLMEngine

    t_start = time.perf_counter()
    results = {}
    # -- phase 1: environment and build ------------------------------------
    card = card_line()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {count} device(s), device 0 = {kind}",
          flush=True)
    # every check runs in IEEE f32, as the reference's tests pin
    # "highest"; the default policy's paths set it where they run
    set_matmul_precision("highest")
    print(f"matmul precision policy {matmul_precision()} (cuBLAS "
          f"{torch.backends.cuda.matmul.fp32_precision}, cuDNN conv "
          f"{torch.backends.cudnn.conv.fp32_precision})", flush=True)
    # the plain versions' half-precision products accumulate in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {built} in {build_s:.2f} s", flush=True)
    results["ptxas"] = {}
    for name in _build.KERNEL_SOURCES:     # cached libraries keep their log
        results["ptxas"][name] = ptxas_summary(_build.build_log(name))
        for fn, regs, spill in results["ptxas"][name]:
            print(f"  ptxas[{name}] {fn}: {regs}; {spill}")
    results["build_s"] = build_s
    # the attention kernels must multiply on the tensor cores: HMMA in
    # every instantiation of K1 forward (6: f32 in three TF32 passes and
    # in one, bf16, each at D 64 and 128), K1c and K1d (12)
    results["sass_hmma"] = {}
    for src, prefix, n in (("flash_attention", "flash_fwd_", 6),
                           ("flash_attention_bwd", "flash_bwd_", 12)):
        mma = sass_mma_counts(_build._lib_path(src))
        if mma is None:
            print(f"cuobjdump not found: SASS of {src} not inspected")
            continue
        got = {kernel_name(k): c for k, c in mma.items() if prefix in k}
        print(f"cuobjdump -sass {src}: HMMA per kernel {got}", flush=True)
        check(len(got) == n and all(got.values()),
              f"{src}: instantiations without HMMA: {got}")
        results["sass_hmma"][src] = got
    # K5a's cluster route and K5b's ring route: bulk copies, and cluster
    # barriers in K5a's int8 instantiations
    results["sass_bulk"] = bulk_copy_sass_check(
        _build._lib_path("fused_decode"))
    trials = [a for a in argv if a.split("=")[0] == "--trials"]
    if trials:
        results["trials"] = trial_phase(torch, dev,
                                        trials[0].partition("=")[2])
    if "--spec" in argv:         # phases 1, 2 at the spec shapes, and 10
        results["spec_rows"] = spec_shape_checks(torch, dev,
                                                 launch_floor(torch))
        results["spec_prefix"] = spec_prefix_phase(
            torch, card, kernel_wrappers(), "--profile" in argv)
        write_results(results)
        print("chip_smoke --spec: phases 1, 2 at the spec shapes and 10 "
              "passed")
        return 0
    if "--k3" in argv:           # phase 1 and K3's rows only: no result
        results["k3"] = k3_phase(torch, dev)
        write_results(results)
        print("chip_smoke --k3: phase 1, K3's sweep and rows passed")
        return 0
    if "--detect" in argv:       # phases 1 and 16 only: no result line
        results["detect"] = detect_phase(torch, card, kernel_wrappers())
        write_results(results)
        print("chip_smoke --detect: phases 1 and 16 passed")
        return 0
    if "--data" in argv:         # phases 1 and 17 only: no result line
        results["data"] = data_phase(torch, card, kernel_wrappers())
        write_results(results)
        print("chip_smoke --data: phases 1 and 17 passed")
        return 0
    if "--array" in argv:        # phases 1 and 15 only: no result line
        results["array"] = array_phase(torch, card, kernel_wrappers())
        write_results(results)
        print("chip_smoke --array: phases 1 and 15 passed")
        return 0
    if "--graphtrain" in argv:   # phases 1 and 14 only: no result line
        results["graphtrain"] = graphtrain_phase(torch, card,
                                                 kernel_wrappers())
        write_results(results)
        print("chip_smoke --graphtrain: phases 1 and 14 passed")
        return 0
    if "--options" in argv:      # phases 1 and 13 only: no result line
        results["options"] = options_phase(torch, card, kernel_wrappers())
        write_results(results)
        print("chip_smoke --options: phases 1 and 13 passed")
        return 0
    if "--front" in argv:        # phases 1 and 11 only: no result line
        results["front"] = front_phase(torch, card, kernel_wrappers())
        write_results(results)
        print("chip_smoke --front: phases 1 and 11 passed")
        return 0
    if "--resnet" in argv:       # phases 1 and 9 only: no result line
        results["resnet"] = resnet_phase(torch, card, kernel_wrappers(),
                                         "--profile" in argv)
        write_results(results)
        print("chip_smoke --resnet: phases 1 and 9 passed")
        return 0
    # -- phase 2: kernels against their plain versions ----------------------
    results["launch_floor_ms"] = launch_floor(torch)
    rows = kernel_checks(torch, dev, results["launch_floor_ms"])
    rows += spec_shape_checks(torch, dev, results["launch_floor_ms"])
    results["paged_edges"] = paged_edge_checks(torch, dev)
    results["variants"] = variant_checks(torch, dev)
    train_rows, results["train_variants"], results["attention"] = \
        train_kernel_checks(torch, dev)
    rows += train_rows
    rows += one_pass_checks(torch, dev)
    fd_rows, results["frontdoor_variants"], user_module, results["rtc"] = \
        frontdoor_kernel_checks(torch, dev)
    rows += fd_rows
    rows += bert_kernel_checks(torch, dev)
    entries = {}
    for row in rows:
        entries.setdefault(row["name"], row)
    if "--kernels" in argv:      # phases 1 and 2 only: no result line
        results["kernels"] = rows
        write_results(results)
        print("chip_smoke --kernels: phases 1 and 2 passed")
        return 0
    if "--zoo" in argv:          # phases 1, 2 and 12 only: no result line
        results["zoo"] = zoo_phase(torch, card, kernel_wrappers())
        bert_row_launches(rows, results["zoo"])
        results["kernels"] = rows
        write_results(results)
        print("chip_smoke --zoo: phases 1, 2 and 12 passed")
        return 0

    # -- phase 3: the main path ---------------------------------------------
    t0 = time.perf_counter()
    model = gpt_like(**CFG)                       # on gpu(0) by default
    from_jax_params(seeded_params(model, SEED), model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"gpt_like {CFG}: {n_params} parameters on "
          f"{model.word_embed.weight.data().device}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompt_lens, prompts = serve_prompts()
    wrappers = kernel_wrappers()
    with LLMEngine(model) as eng:                 # int8 KV, block 16, 8 lanes
        # the decode graph and the prompts' prefill buckets are captured
        # ahead of traffic; a warm-up request keeps other first-call
        # costs out of the measured run
        t0 = time.perf_counter()
        buckets = eng.warmup([len(p) for p in prompts])
        warm_s = time.perf_counter() - t0
        warm = eng.stats()["graphs"]
        eng.generate(prompts[0][:16], 4)
        before = eng.stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        handles = [eng.submit(p, NEW_TOKENS) for p in prompts]
        outs = [h.wait(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = {k: w.launches for k, w in wrappers.items()}
        after = eng.stats()
    print(f"warmup: buckets {buckets}, {warm['captures']} graphs captured "
          f"in {warm['capture_s']:.3f} s ({warm_s:.3f} s in warmup())",
          flush=True)
    check(warm["captures"] == len(buckets) + 1,
          f"warmup captured {warm['captures']} graphs for {buckets}")
    for out in outs:
        check(out.shape == (NEW_TOKENS,), f"request returned {out.shape}")
        check(((out >= 0) & (out < CFG["vocab_size"])).all(),
              "token out of vocabulary")
    steps = (after["counters"]["decode_steps"]
             - before["counters"]["decode_steps"])
    prefills = after["counters"]["prefills"] - before["counters"]["prefills"]
    layers = CFG["num_layers"]
    expected = dict({k: 0 for k in wrappers},
                    layer_norm_fwd=(2 * layers + 1) * (prefills + steps),
                    paged_attention=layers * steps,
                    qkv_project=layers * steps, out_project=layers * steps)
    print(f"served {len(prompts)} requests (prompt lengths "
          f"{prompt_lens.tolist()}, {NEW_TOKENS} new tokens each): "
          f"{prefills} prefills, {steps} decode steps, launches {counts}, "
          f"expected {expected}", flush=True)
    check(prefills == len(prompts), f"{prefills} prefills")
    check(counts == expected, f"launch counts {counts} != {expected}")
    replays = after["graphs"]["replays"] - before["graphs"]["replays"]
    check(after["graphs"]["captures"] == before["graphs"]["captures"]
          and replays == prefills + steps,
          f"served run: graphs {before['graphs']} -> {after['graphs']}, "
          f"{prefills} prefills and {steps} steps")
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)   # the train phases reset
    dec_s = after["decode_s"] - before["decode_s"]
    pre_s = after["prefill_s"] - before["prefill_s"]
    dec_tok = after["decode_tokens"] - before["decode_tokens"]
    serve = {"wall_s": wall, "tok_s": len(prompts) * NEW_TOKENS / wall,
             "decode_step_ms": 1e3 * dec_s / steps,
             "prefill_ms": 1e3 * pre_s / prefills,
             "decode_tok_s": dec_tok / dec_s, "decode_steps": steps,
             "prompt_lens": prompt_lens.tolist(), "buckets": buckets,
             "graph_captures": warm["captures"],
             "graph_capture_s": warm["capture_s"], "warmup_s": warm_s,
             "graph_replays": replays, "card": card}
    results["serve"] = serve
    print(f"serve on {card}, replaying CUDA graphs: prefill_ms "
          f"{serve['prefill_ms']:.3f} (mean of {prefills}), decode_step_ms "
          f"{serve['decode_step_ms']:.3f} (host wall per engine step, mean "
          f"of {steps}), tok_s {serve['tok_s']:.1f} end to end, decode "
          f"tok_s {serve['decode_tok_s']:.1f}; {replays} replays",
          flush=True)

    # -- phase 4: output checks, at the served batch's mid-decode lengths ---
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    lengths = prompt_lens + NEW_TOKENS // 2
    check(lengths.tolist() == mid_decode_lengths(), "mid-decode lengths")
    args = decode_state(torch, model, lengths, g)
    toks, pk, pv, table, pos = args

    def step_logits():
        with torch.no_grad():
            return model.decode_step_paged(toks, pk.clone(), pv.clone(),
                                           table, pos)[0]

    lg_kernel = step_logits()
    with tnn.no_kernels():
        lg_plain = step_logits()
    # the projections on cuBLAS around K4 and K2: a comparison path
    env_fused = os.environ.get("MXNET_TPU_LLM_FUSED_DECODE")
    os.environ["MXNET_TPU_LLM_FUSED_DECODE"] = "0"
    for w in wrappers.values():
        w.launches = 0
    lg_unfused = step_logits()
    unfused_counts = {k: w.launches for k, w in wrappers.items()}
    if env_fused is None:
        del os.environ["MXNET_TPU_LLM_FUSED_DECODE"]
    else:
        os.environ["MXNET_TPU_LLM_FUSED_DECODE"] = env_fused
    check(unfused_counts == dict({k: 0 for k in wrappers},
                                 layer_norm_fwd=2 * layers + 1,
                                 paged_attention=layers),
          f"MXNET_TPU_LLM_FUSED_DECODE=0 launched {unfused_counts}")
    # 12 layers of f32 sums in another order, plus int8 K/V of the new
    # token that may round one step apart (one step ~1% of a value)
    tol = 2e-3
    errs = {}
    for path, lg in (("kernels", lg_kernel), ("fused decode off", lg_unfused)):
        check(torch.isfinite(lg).all().item(), f"{path}: non-finite logits")
        err = (lg - lg_plain).abs().max().item()
        same = (lg.argmax(-1) == lg_plain.argmax(-1)).float().mean().item()
        print(f"decode step int8 KV at lengths {lengths.tolist()}, {path} vs "
              f"plain path on the card: logits max_abs_err {err:.3e} (tol "
              f"{tol:g}), argmax agreement {same}", flush=True)
        check(err <= tol, f"decode-step logits: {path} vs plain {err} > {tol}")
        errs[path] = err
    results["decode_step_logits_err"] = errs
    del lg_kernel, lg_plain, lg_unfused

    check_prompts = [prompts[1][:40], prompts[2][:23]]
    with LLMEngine(model, kv_cache_dtype="float32") as eng:
        paged = [eng.generate(p, 8) for p in check_prompts]
    dense = [generate(model, p[None], 8).cpu().numpy()[0]
             for p in check_prompts]
    for a_, b_ in zip(paged, dense):
        check(np.array_equal(a_, b_), f"paged engine {a_.tolist()} != "
              f"dense generate {b_.tolist()}")
    print("paged engine (f32 KV, kernels, CUDA graphs) == dense generate: "
          "greedy tokens identical on 2 prompts x 8 tokens", flush=True)
    run = paged_decode_program(model)
    results["replay_vs_eager"] = replay_equals_eager(
        torch, model, run, args, g, prompts[3], wrappers)
    results["sampling"] = sampling_check(torch, model, prompts[4][:40])

    # -- phase 5: the same decode step, replayed and eager -------------------
    step = {"lengths": lengths.tolist()}
    for path in ("kernels", "plain"):
        for mode, call in (("replayed", run), ("eager", run.eager)):
            with tnn.no_kernels() if path == "plain" else nullcontext():
                dev_ms, host_ms = time_ms(lambda i: call(*args, g), iters=10,
                                          warmup=2)
            step[f"{path} {mode}"] = {"device_ms": dev_ms, "host_ms": host_ms,
                                      "device_busy": dev_ms / host_ms}
            print(f"decode step on {card}, {path} path {mode}, lengths "
                  f"{step['lengths']}: device_ms {dev_ms:.4f} host_ms "
                  f"{host_ms:.4f} (device busy {dev_ms / host_ms:.3f})",
                  flush=True)
    step["graphs"] = {"captures": run.captures, "replays": run.replays,
                      "capture_s": run.capture_s}
    if "--profile" in argv:
        prof_ms = profile_decode(torch, run, args, g)
        step["profiler_device_ms"] = prof_ms
        print(f"decode step, profiler: device ms per step summed over "
              f"kernels: {'not measured' if prof_ms is None else prof_ms}",
              flush=True)
    results["decode_step"] = step
    del args, pk, pv
    results["prefill_step"] = prefill_times(torch, model, card, prompts,
                                            buckets)

    # -- phase 6: a train step's loss and gradients, kernels against plain --
    results["train_check"] = train_grad_check(torch, model, dev, wrappers)

    # -- phase 7: the train main path, under each matmul policy ---------------
    for policy in ("highest", "default"):
        with matmul_precision_scope(policy):
            train = train_phase(torch, model, dev, card, wrappers,
                                "--profile" in argv, policy)
        results[f"train_{policy}"] = train
        for row in rows:       # the one-pass rows take the default's counts
            base = row["name"].removesuffix("_tf32")
            if ((base != row["name"]) == (policy == "default")
                    and TRAIN_LAUNCHES.get(base)
                    and base != "layer_norm_fwd"):
                row["launches"] = train["launches"][base]

    # -- phase 8: the front-door path ------------------------------------------
    del model, run         # free gpt_like: the stack's peak is its own
    torch.cuda.empty_cache()
    scale_kernel = user_module.get_kernel(
        "row_absmax_scale", "const float *x, int d, float *o")
    front = frontdoor_phase(torch, card, wrappers, scale_kernel,
                            "--profile" in argv)
    results["frontdoor"] = front
    for row in rows:
        if row["name"] in ("rms_norm_fwd", "rtc_row_absmax_scale"):
            row["launches"] = front["default"]["launches"][row["name"]]

    # -- phase 9: the ResNet path -----------------------------------------
    torch.cuda.empty_cache()
    results["resnet"] = resnet_phase(torch, card, wrappers,
                                     "--profile" in argv)

    # -- phase 10: speculative decoding and the shared-prefix cache ---------
    torch.cuda.empty_cache()
    results["spec_prefix"] = spec_prefix_phase(torch, card, wrappers,
                                               "--profile" in argv)

    # -- phase 11: the training front door ------------------------------------
    torch.cuda.empty_cache()
    results["front"] = front_phase(torch, card, wrappers)

    # -- phase 12: BERT-base pretraining and the rest of the model zoo ------
    torch.cuda.empty_cache()
    results["zoo"] = zoo_phase(torch, card, wrappers)
    bert_row_launches(rows, results["zoo"])

    # -- phase 13: LLMEngine's single-engine options ----------------------
    torch.cuda.empty_cache()
    results["options"] = options_phase(torch, card, wrappers)

    # -- phase 14: the compiled training step -------------------------------
    torch.cuda.empty_cache()
    results["graphtrain"] = graphtrain_phase(torch, card, wrappers)

    # -- phase 15: the array layer ---------------------------------------------
    torch.cuda.empty_cache()
    results["array"] = array_phase(torch, card, wrappers)

    # -- phase 16: SSD300 detection and the contrib ops ---------------------
    torch.cuda.empty_cache()
    results["detect"] = detect_phase(torch, card, wrappers)

    # -- phase 17: the flagship example's data loop -------------------------
    torch.cuda.empty_cache()
    results["data"] = data_phase(torch, card, wrappers)

    results["kernels"] = rows
    results["seconds"] = time.perf_counter() - t_start
    write_results(results)
    print(f"total {results['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in LINE_KEYS}
                                  for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
