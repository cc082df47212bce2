#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. environment: torch, CUDA, nvcc, the card and its power limit;
2. build: every CUDA source of the port compiled with nvcc for sm_90a,
   one nvcc per source, all started together;
3. kernels against their plain PyTorch versions on the card, then timed:
   the signature kernel bit for bit on both its routes (vec and strided)
   at the CNN path's shape and at ragged shapes (float32), and at each
   LM-family path's width in bfloat16 and float32, also in its bucketed
   form, and at the LM cohort legs' per-sample shapes with their rows,
   then timed at each path's shape by both routes; flash attention at
   the LM and hybrid paths' shapes and the hybrid cohort leg's batch of
   4 (each from separate (B,S,H,hd)
   tensors and from views into one fused qkv), at every shape of the
   reference's FLASH_CASES in float32 and bfloat16, at head_dim 256
   with a window and a soft-cap, at MLA's head dim 192 on its path's
   shape, at gemma3's 8,192 tokens with its window of 1,024 and without,
   at a ragged 4,100 tokens, and at whisper's decoder prefill (16 query
   over 16 KV heads of 64, 384 tokens; the plain versions over every
   head, a group of KV heads at a time): every bfloat16 case on the
   Hopper kernel (wgmma, TMA) within the reference's 2e-2 and within
   FLASH_TC_TOL of the plain version of its own arithmetic, every float32
   case on the FMA
   kernel within 2e-5, each case's route read from the per-route counts;
   the selective scan kernel
   within the reference's 1e-5 of both its plain versions (the reference's
   arithmetic and its own) at the reference's SCAN_CASES, at the
   hybrid path's shape and the hybrid cohort leg's batch of 4 (with B and
   C as the strided views the model splits out of one projection), at a
   ragged length from a non-zero state, and
   across two calls that carry the state; the chunkwise mLSTM kernel
   within the reference's 1e-4 (h and the last C, n, m) at the reference's
   MLSTM_CASES, at the xLSTM path's bfloat16 shape (the gates as strided
   views) and at a ragged length over a partial v tile, against both the
   reference's chunk loop and the kernel's own two-pass form; the sLSTM
   kernel within the reference's 1e-5 (hs; 1e-4 for the states) at its
   SLSTM_CASES, at the xLSTM path's shape from a fresh and a carried
   state, at a ragged width, at batches 43 and 64 (one launch each), and
   across two calls that carry the state; then its time a step and the
   time a step of its exchange alone (the step loop without products);
4. the CNN path: the sequential DAG-AFL loop over four full-width VGG16
   clients on 32x32x3 images, driven through ``CNNBackend`` and
   ``DagAflCoordinator.run``, with every kernel's launch count set to 0
   just before and read just after (every signature launch on the vec
   route); and the card's forward pass held against the port's CPU
   forward on a small input;
5. the CNN cohort path: the same world and loop with ``cohort_size=4`` and
   ``cohort_window=2.0``, so that round starts in one window are trained,
   validated and signed together on ``fl.cohort.CohortBackend`` (grouped
   convolutions over the stacked clients, one signature launch per
   client, every one on the vec route), after warm-up windows, with the
   launch counts set to 0 just before and read just after; then one
   window's aggregates and seeds trained again by ``train_local``, its
   models validated by ``evaluate`` and signed by ``signature``, and held
   against the window's results: trained leaves within the reference's
   5e-3, the same correct counts, signatures within 1/1024 per channel;
6. the baselines: the paper's competitors (``fl.baselines.ALGORITHMS``,
   all ten) over the same four clients for 2 rounds from one genesis,
   then fedavg, fedasync, fedat, csafl, DAG-FL and DAG-AFL again on the
   cohort engine, each run counted on its own (wall and card-side call
   seconds, client rounds, simulated time, accuracy, peak memory); the
   expected round counts, at least one window per cohort run, the DAG
   runs' ledgers verified and every signature launch on the vec route;
7. the scenarios: DAG-AFL on the cohort engine for 3 rounds, honest and
   under each of ``fl.scenarios.SCENARIOS`` (poison, lazy, dp, straggler,
   dropout), and poison on fedavg and fedasync beside their honest runs:
   each scenario's event counter nonzero, tampered metadata caught exactly
   by ``detect_tampered`` and flagged by the incremental audit, the DAG
   quarantine metrics and the accuracy change; then the update transform
   on VGG16's own leaves (a window of 4 equal to the single calls bit for
   bit, the unaffected row kept, the DP noise's moments within 1%);
8. the LM path: the same loop over four internlm2-1.8b clients at full
   width (depth cut to 4 of 24 layers, token streams drawn from a
   2,048-token sub-vocabulary), driven through ``LMBackend``, with the
   launch counts set to 0 just before and read just after (every flash
   launch on the Hopper kernel, every signature launch on the vec route,
   on this path and the next two); and the
   kernel forward of the final global model held against its
   plain-attention forward on the card; then one profiled backend round;
9. the hybrid path: the same loop over three jamba-v0.1-52b clients at
   full width, depth cut to one Mamba and one attention layer with dense
   feed-forward layers (its MoE layers are phase 15's), with the launch
   counts set to 0 just before and read just after; the kernel forward
   (selective scan and flash attention) held against the plain forward
   (the model's chunked scan and dense attention) on the card; then one
   profiled backend round;
10. the xLSTM path: the same loop over three xlstm-125m clients at full
   width, depth cut to one published period ([mLSTM x3, sLSTM],
   70,563,864 parameters: with remat its sLSTM step loop runs twice a
   training step), the
   launch counts set to 0 just before and read just after; the kernel
   forward (chunkwise mLSTM and sLSTM kernels) held against the plain
   forward (the model's chunkwise form and step loop) on the card; then
   one profiled backend round;
11. the LM cohort path: the same loop over the three LM families on the
   cohort engine (``fl.cohort.LMCohortPrograms``, ``cohort_window=2.0``):
   internlm2 with 3 clients in windows of up to 2 at batch 8, the hybrid
   with 2 clients in windows of 2 at batch 4, xLSTM (the xLSTM path's
   one-period cut) with 3 clients in windows of up to 3 at batch 8
   (LM_COHORT_LEGS), each timed by engine
   call against its sequential path above, with the launch counts set to
   0 just before and read just after (every launch counted against the
   forwards the run made: one signature launch a round on the vec route,
   flash on the sm90 route, no plain call); then one window redone by the
   sequential calls: trained leaves within 5e-3 and within twice the
   training's one-ulp floor (xLSTM with float32 products; bfloat16, its
   floor and one step's gradients per layer reported), the argmax token
   at every position of the validation forwards equal to ``evaluate``'s,
   signatures within one flag of a row (1/(S*w)) per bucket;
12. the train path: ``launch.train.train_single`` on internlm2 at the LM
   path's width, 10 AdamW steps (clip 1.0, the signature in the metrics)
   over a ``TokenPipeline`` of the sub-vocabulary, batch 8 x 512: a finite
   loss whose last 3 steps' mean is below step 0's, one signature launch a
   step on the vec route and no other kernel, a checkpoint round trip bit
   for bit, and one eval step on the kernels; then one SGD and one AdamW
   step on 4,096 parameters on the card and on the CPU, bit for bit;
13. the serve path: ``launch.serve.serve`` at full width (weights and
   prompts from seed 0, batch 8, a 512-token prompt, 64 new tokens) over
   internlm2 (4 layers), the Jamba cut and xlstm-125m, with the launch
   counts set to 0 just before and read just after (one prefill: each
   kernel once a layer of its kind, flash on the sm90 route, no plain
   version): prefill and decode times, decode tokens/s, peak memory (5 GB
   of the card left free) and the decode step's weight-read bound; then
   the same weights and prompts in float32 compute, each step's logits
   within the reference's 2e-2 of a teacher-forced full forward, the
   greedy tokens its argmax wherever the top-2 gap exceeds twice the
   error, every attention cache grown by 64 slots; the bfloat16 readings
   beside it;
14. the serving path: ``DagAflCoordinator`` with serving on, over the CNN
   path's world and the LM path's (cadence a quarter of the path's
   simulated time, 12 expected queries over it, batch 8; the LM queries
   512-token prompts and 16 new tokens), with the launch counts set to 0
   just before and read just after (each LM query one prefill on the
   kernels); at least 3 replica versions and 8 queries, none skipped, the
   version histogram summing to the queries, every replica equal to a
   fresh Eq. 6 over its refs bit for bit, the last LM replica's tokens
   equal to those of Eq. 6 over its refs, the ledgers verified; and
   whether its tx ids and Eq. 7 hashes equal those of the same world
   without serving (and, where they do not, of that world run twice);
15. the MoE path: jamba-v0.1-52b at full width cut to layers 4 and 5 of
   its period, ``(attn, dense)`` and ``(mamba, moe)`` (16 experts of
   14,336, top-2; 3,678,941,184 parameters), in three legs, each with
   the launch counts set to 0 just before and read just after:
   ``moe_backend``, ``LMBackend.evaluate`` and ``signature`` (the
   tip-selection forwards, ``mode="prefill"``) at batch 8 x 512 (flash
   and the scan once a forward, flash on sm90, the signature once a
   signature call on vec, no plain call), then the kernel forward against
   the plain forward in float32 (at least 99.9% of the tokens routed to
   the same experts, logits within the reference's 2e-2 on those) and in
   bfloat16 (reported); ``moe_train``, ``launch.train.train_single`` for
   10 AdamW steps with bfloat16 moments at batch 8 x 512 (``moe_aux``
   finite and above 0 at every step, the loss falling, one signature
   launch a step, the peak leaving 5 GB of the card free; the choices
   the capacity dropped each step); ``moe_serve``, the serve leg above
   at this config (the steps whose tokens the serve run and the
   teacher-forced forward route to other experts, or whose choices one
   run's capacity dropped, are reported and left out of the float32
   comparison);
16. the attention variants (``attention_variants_path``), each leg with
   the launch counts set to 0 just before and read just after and its
   peak leaving 5 GB of the card free:
   ``gemma3_backend``, gemma3-27b at full width cut to one published
   period (5 local layers of window 1,024, then a global one;
   3,886,616,832 parameters): ``LMBackend.evaluate`` and ``signature`` at
   batch 2 x 8,192 (flash 6 times a forward, all sm90; one signature
   launch a signature call, on vec; flash launches by window counted
   where they launch and gated against the layers'), then the kernel
   forward against the plain forward (banded for the local layers,
   chunked for the global one, each counted) in float32 (logits within
   2e-2) and bfloat16 (reported); ``gemma3_train``, one warm-up step and
   then 2 steps of ``train_local`` at batch 1 x 4,096 tokens with 5 GB of
   the card free (the banded and chunked paths and the chunked
   cross-entropy under autograd, counted; no kernel), the mean loss below
   the start's and no allocator retry in the counted steps; ``gemma3_serve``,
   the serve leg of phase 13 at batch 2, an 8,192-token prompt and 32 new
   tokens (decode over the windowed cache); ``mla_backend``,
   deepseek-v2-236b cut to its dense prologue and one MoE layer (160
   experts top-6, 2 shared; 5,193,528,320 parameters) as phase 15's
   backend leg at batch 8 x 512, flash at head dim 192 twice a forward;
   ``mla_serve``, the serve leg (absorbed MLA decode over the ``ckv`` and
   ``krope`` caches); ``mla_train``, phase 15's train leg on the dense
   prologue (1,221,411,840 parameters, bfloat16 moments); ``mrope`` and
   ``mrope_train``, qwen2-vl-72b cut to one layer (3,369,109,504
   parameters): the kernel forward at batch 8 x 512 over M-RoPE positions
   laid out as Qwen2-VL lays out an image (text, a 16 x 24 patch grid,
   text), the float32 kernel forward against the plain one within 2e-2,
   the same batch at text-only positions moving the logits past the grid
   (and not before it), then 5 AdamW steps at two microbatches with the
   grid positions (one signature launch a microbatch);
17. the whisper path (``whisper_path``): whisper-medium at full width and
   depth (24 encoder layers over 1,500 frames, 24 decoder layers with
   cross-attention; 959,329,280 parameters, counted leaf by leaf), each
   leg with the launch counts set to 0 just before and read just after
   and its peak leaving 5 GB of the card free: ``whisper_serve``, the
   serve leg of phase 13 at batch 8, a 384-token prompt and 64 new
   tokens, frame embeddings N(0, 1) * 0.1 from seed 0 (flash 24 times a
   prefill, all sm90 at window -1, none inside the encoder, whose
   non-causal attention takes the dense scores; the cross caches bit for
   bit across the decode steps); ``whisper_query``, one
   ``LMQueryDriver.decode_prompts`` call (zero frame embeddings) whose
   tokens equal ``greedy_decode``'s on the same prompts bit for bit;
   ``whisper_train``, 10 AdamW steps of ``train_single`` at batch 4 x
   448 tokens with the launcher's zero frame embeddings (one signature
   launch a step on vec, no flash, no allocator retry, the loss falling).

18. the mesh path (``mesh_path``), the cohort engine and the sLSTM scan
   over device meshes, each leg with the launch counts set to 0 just
   before and read just after: ``mesh_auto``, the CNN engine at full
   VGG16 width with ``mesh="auto"`` (on one card the single-device engine,
   bit for bit against ``mesh=None``); ``mesh_cnn``, a 1-D mesh over
   ``[cuda:0] * 2`` and a 2x2 mesh over ``[cuda:0] * 4`` at a ragged K of
   3 and 5: ``train_cohort``, ``evaluate_cohort``, ``evaluate_shared``,
   ``evaluate_many`` and ``signature_cohort`` against the single-device
   engine (weights 5e-3, losses 5e-2, accuracies 1e-4, signatures 1e-2,
   the reference's ``tests/test_cohort_mesh.py``), ``stacked_mean`` and
   ``stacked_weighted`` at 1e-6; ``mesh_dag``, DAG-AFL (4 clients, 2
   rounds) on the 2x2 mesh with ``chain_len == 1 + rounds`` and the DAG
   verified, ``s_per_round`` with the mesh and without it; ``mesh_lm``,
   internlm2-1.8b at full width and 2 layers, K = 2 on a 2x1 mesh (flash
   and the signature launched per group and counted, every call against
   the single-device engine); ``mesh_slstm``, xlstm-125m's forward with
   ``Runtime(mesh=...)`` over 2 batch devices (the sLSTM kernel once a
   shard and layer; each layer's sharded scan within the reference's
   sLSTM tolerances of the unsharded scan on the same inputs, 1e-5 for
   hs; the logits within LM_LOGIT_RTOL of the largest, their error and
   whether they are bit-equal reported, in float32 and bfloat16) and one
   backward: each layer's sharded scan's gate-weight gradients within
   1e-5 of their scale, the whole loss's reported.  With
   more than one card ``mesh_cnn`` and ``mesh_lm`` also run over distinct
   cards; ``device_count`` is printed either way.
19. the dense configs whole (``dense_configs_path``), random weights from
   seed 0, each leg with the launch counts set to 0 just before and read
   just after and its peak leaving 5 GB of the card free, parameters
   counted leaf by leaf: ``gemma2_backend``, gemma2-2b (26 layers, 13 x
   (local 4,096, global), head dim 256, soft-cap 50; 2,614,222,080
   parameters): ``LMBackend.evaluate`` and ``signature`` at 2 x 8,192
   (flash 13 times at window 4,096 and 13 at -1 a forward, all sm90; one
   signature launch a call on vec), the kernel forward against the plain
   forward (banded and chunked) in float32 within 2e-2 and in bfloat16
   (reported); ``gemma2_train``, 10 AdamW steps of ``train_single`` with
   remat at GEMMA2_TRAIN (the loss falling, one signature launch a step,
   no allocator retry), then one loss gradient with ``remat=False`` and
   one with ``remat=True`` from the same weights and batch at
   GEMMA2_REMAT_CHECK: bit for bit, or no further apart than two runs
   without remat, with each one's ms and peak; ``gemma2_serve``, the
   serve leg at 2 x (8,192 + 32); ``qwen2_backend`` and ``qwen2_serve``,
   qwen2-7b whole (28 layers, QKV biases, GQA 28 over 4;
   7,615,616,512 parameters) at 8 x 512 (flash 28 times a forward) and 8
   x (512 + 64); ``qwen2_train``, 10 AdamW steps at 8 x 512 on its
   deepest cut of whole layers that leaves 5 GB free and runs without an
   allocator retry (``qwen2_train_config``).
20. the dry run's sharded count (``dryrun_path``), in a subprocess on the
   card's host (its torch may not be the tests'; the fake process group
   is a ``torch.testing._internal`` module): ``launch.dryrun.build_step``
   on DTensors over a fake (4, 2) mesh for the five reduced cases of
   DRYRUN_CASES, each counted once: per-chip FLOPs, collective bytes by
   kind and peak bytes printed; every count positive, collectives in
   every case, no process group left initialised.

Every training leg runs with ``Runtime.remat`` on, the default: each
period of the forward is checkpointed and run again in the backward, so
a leg that counts the plain score paths or the MoE routings counts each
period twice, and ``moe_train`` holds the recompute's routing equal to the
forward's.

Each path's run is counted on its own: every kernel's count is set to 0
just before it and read just after.  Then one line ``{"kernels": [...]}``
with each kernel's launches on the main paths, its error against the
plain version and its times beside its bound; the card's name and power
limit as ``nvidia-smi`` prints them; and last ``{"ok": true, "device":
{...}}``.  Any failed check exits non-zero without that last line, as does
a host without CUDA or a directory that holds this script and nothing else
of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
# tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12        # dense, tensor cores
MAIN_SHAPE = (128, 1024, 64)   # VGG16 conv 1 at 32x32, 128 samples
RAGGED_SHAPE = (3, 1000, 63)
# the LM-family paths' final-norm outputs, bfloat16, batch 8 of 512
# positions, at each model's width: xlstm-125m, internlm2-1.8b, jamba, and
# the attention variants' widths
SIG_WIDTHS = {"xlstm": (1, 8 * 512, 768), "lm": (1, 8 * 512, 2048),
              "hybrid": (1, 8 * 512, 4096),
              # the attention variants: gemma3-27b at batch 2 x 8,192,
              # deepseek-v2 and qwen2-vl-72b at 8 x 512
              "gemma3": (1, 2 * 8192, 5376), "mla": (1, 8 * 512, 5120),
              "mrope": (1, 8 * 512, 8192),
              # whisper-medium's training at batch 4 x 448
              "whisper": (1, 4 * 448, 1024),
              # the dense configs: gemma2-2b at 2 x 8,192, qwen2-7b at
              # 8 x 512
              "gemma2": (1, 2 * 8192, 2304), "qwen2": (1, 8 * 512, 3584)}
# d % 64 != 0 (on the vec route), and d % 8 != 0 (on the strided route)
LM_SIG_RAGGED = [(2, 300, 1000), (3, 257, 100)]
# the LM cohort legs' per-sample rows: one launch over a client's (B, S, d)
# final-norm output (per_sample_signature), bfloat16
SIG_PER_SAMPLE = {"xlstm_cohort": (8, 512, 768), "lm_cohort": (8, 512, 2048),
                  "hybrid_cohort": (4, 512, 4096)}
FLASH_MAIN = (8, 16, 8, 512, 128)   # B, H, K, S, hd; causal, bfloat16
FLASH_HYBRID = (8, 32, 8, 512, 128)  # the hybrid path's attention layer
FLASH_HYBRID_COHORT = (4, 32, 8, 512, 128)   # the hybrid cohort leg's
# tests/test_kernels.py FLASH_CASES: B, H, K, S, hd, causal, window, cap
FLASH_CASES = [(2, 4, 2, 256, 64, True, -1, 0.0),
               (1, 4, 4, 300, 32, True, 48, 0.0),
               (2, 2, 1, 128, 64, True, -1, 30.0),
               (1, 2, 2, 200, 64, False, -1, 0.0),
               (1, 8, 2, 256, 128, True, 128, 50.0),
               (2, 4, 2, 192, 64, True, -1, 0.0)]
FLASH_HD256 = (1, 8, 4, 1024, 256, True, 256, 50.0)   # gemma2's head_dim
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}       # the reference's
# the Hopper kernel against the plain version of its own arithmetic: one
# bfloat16 rounding of the output (2^-8 relative, here 2^-7), and P rounded
# against the running rather than the final row max (2e-3 absolute)
FLASH_TC_TOL = {"atol": 2e-3, "rtol": 2 ** -7}
LM_DATA_VOCAB = 2048
# the hybrid path: jamba-v0.1-52b at full width, batch 8 of 512 positions
SCAN_MAIN = (8, 512, 8192, 16)       # B, S, d_in, N
# tests/test_kernels.py SCAN_CASES (B, S, d_in, N), one with d_in % 4 != 0
# (x and dt copied a float at a time, not in 16-byte pieces), and a ragged
# S (not a multiple of the kernel's 8-step tile) over a partial block of
# channels
SCAN_CASES = [(1, 64, 8, 4), (2, 100, 16, 8), (3, 37, 4, 2),
              (2, 45, 130, 16)]
SCAN_RAGGED = (2, 301, 200, 16)
SCAN_HYBRID_COHORT = (4, 512, 8192, 16)   # the hybrid cohort leg, batch 4
SCAN_TOL = 1e-5                      # rtol and atol, the reference's
SFU_EXP_PER_CLOCK_SM = 16            # H100: special-function unit rate
H100_SMS, H100_BOOST_HZ = 132, 1.98e9
HYBRID_PARAMS = 1_036_464_128        # the reference's tree at this cut
# the card's kernel forward against its plain forward, bfloat16 end to end
# (the plain attention rounds the scaled q and the softmax weights to
# bfloat16, the kernel keeps them in float32; both scans are float32 and
# differ in the last bits, which the bfloat16 casts after them can round
# apart): logits within LM_LOGIT_RTOL of the largest logit, signature
# buckets within LM_SIG_TOL (about 650 net flags of the 131,072 per bucket
# at internlm2's width)
LM_LOGIT_RTOL = 0.05
LM_SIG_TOL = 0.005
# the xLSTM path: xlstm-125m at full width and depth, batch 8 of 512
MLSTM_MAIN = (8, 512, 4, 192, 384)   # B, S, H, dk, dv; bfloat16 q, k, v
# tests/test_kernels.py MLSTM_CASES (B, S, H, dk, dv, chunk), and a ragged
# S (not a multiple of the kernel's 64-step chunk) over a partial v tile
MLSTM_CASES = [(2, 100, 2, 16, 24, 16), (1, 64, 4, 32, 32, 64),
               (2, 50, 1, 8, 8, 13)]
MLSTM_RAGGED = (2, 301, 3, 64, 100, 256)
MLSTM_TOL = 1e-4                     # rtol and atol, the reference's
MLSTM_BOUND_CHUNK = 32               # the chunk length the bound counts
SLSTM_MAIN = (8, 512, 768)           # B, S, d
# tests/test_kernels.py SLSTM_CASES (B, S, d), and ragged widths (a partly
# filled last block of the persistent grid) over an odd S, at 2 and 8
# units per block
SLSTM_CASES = [(2, 100, 32), (1, 64, 16), (3, 50, 8)]
SLSTM_RAGGED = [(3, 301, 100), (3, 301, 1001)]
# batches past the first kernel's limit of 42 rows at xlstm-125m's width
SLSTM_BATCHES = [(43, 128, 768), (64, 128, 768)]
SLSTM_TOL = {"hs": 1e-5, "state": 1e-4}   # rtol and atol, the reference's
# R's scale: the reference's kernel tests draw N(0, 1) x 0.05 at widths up
# to 32; the model draws r_gates at 0.01 (models.xlstm.init_slstm).  At
# 0.05 x sqrt(d) > 1 the recurrence expands, and any two float32 orders of
# the h @ R sums drift apart over the sequence: wider cases take the
# model's scale, and the drift at 0.05 is measured against float64
SLSTM_R_SCALE, SLSTM_MODEL_R_SCALE = 0.05, 0.01
XLSTM_PARAMS = 134_421_576           # the reference's tree, leaf by leaf
XLSTM_LOOP_PARAMS = 70_563_864       # its first period alone
# the MoE path: the hybrid cut less one dense FFN, plus 16 experts and a
# router (the reference's tree, leaf by leaf)
MOE_PARAMS = 3_678_941_184
MOE_ROUTED_ALIKE_MIN = 0.999         # tokens routed alike by two forwards
MOE_FREE_BYTES_MIN = 5e9             # every MoE and variant leg's peak
#                                      leaves this much of the card free
# the attention variants: the reference's trees, leaf by leaf (jax.eval_shape)
GEMMA3_PARAMS = 3_886_616_832        # gemma3-27b, one published period
MLA_PARAMS = 5_193_528_320           # deepseek-v2: dense prologue + 1 MoE
MLA_PROLOGUE_PARAMS = 1_221_411_840  # deepseek-v2's dense prologue alone
MROPE_PARAMS = 3_369_109_504         # qwen2-vl-72b, one layer
GEMMA3_BATCH, GEMMA3_SEQ, GEMMA3_NEW = 2, 8192, 32
# gemma3's local training, batch 1: the peak (73.9 GB on an 85.0 GB card)
# leaves MOE_FREE_BYTES_MIN free; running out of memory fails the phase
GEMMA3_TRAIN_SEQ = 4096
# Qwen2-VL's layout of one image in a 512-token row: text, a 16 x 24
# patch grid, text (arXiv:2409.12191 §2.1)
MROPE_LAYOUT = (64, 16, 24, 64)
MROPE_TRAIN_STEPS = 5
FLASH_GEMMA3 = (2, 32, 16, 8192, 128)    # windows 1,024 (local), -1
FLASH_MLA = (8, 128, 128, 512, 192)      # MLA: 128 nope + 64 rope
FLASH_RAGGED_LONG = (1, 4, 2, 4100, 128)  # past 4,096, ragged
FLASH_WHISPER = (8, 16, 16, 384, 64)     # whisper's decoder, its prefill
WHISPER_PARAMS = 959_329_280             # whisper-medium, leaf by leaf
WHISPER_SERVE = (8, 384, 64)             # batch, prompt, new tokens: 448
WHISPER_TRAIN = (4, 448)                 # batch, tokens: its text context
WHISPER_QUERY = (8, 384, 16)             # batch, prompt, new tokens
# the dense configs whole: the reference's trees, leaf by leaf
# (``param_count()`` leaves out gemma2's 122,112 norm weights and qwen2's
# 333,312 norm weights and QKV biases)
GEMMA2_PARAMS = 2_614_222_080            # gemma2-2b, 13 x (local, global)
QWEN2_PARAMS = 7_615_616_512             # qwen2-7b, 28 layers
GEMMA2_BATCH, GEMMA2_SEQ, GEMMA2_NEW = 2, 8192, 32
# gemma2's training: the largest batch of 1,024 tokens whose peak leaves
# MOE_FREE_BYTES_MIN of the card free (AdamW's 47.1 GB of state and the
# unchunked cross-entropy over 256,000 tokens: 75.0 GB at 6, 81.3 GB at
# 7, out of memory at 8; PERF.md section 5); then loss gradients with
# remat and without at a shape that fits both ways
GEMMA2_TRAIN = (6, 1024)
GEMMA2_REMAT_CHECK = (2, 1024)
# qwen2's training: AdamW in float32 takes 18 bytes a parameter (137 GB
# whole), so the deepest cut of whole layers whose peak leaves
# MOE_FREE_BYTES_MIN free and whose steps run without an allocator retry
# (12 layers peak at 79.2 GB, 5.9 GB free, and 11 layers both made the
# allocator retry once; PERF.md section 5): its embeddings and final
# norm, and this many layers of 233,057,792 parameters
QWEN2_TRAIN_LAYERS = 10
QWEN2_TRAIN_PARAMS = (2 * 152_064 * 3_584 + 3_584
                      + QWEN2_TRAIN_LAYERS * 233_057_792)
# the dry run's reduced cases, the reference's tests/test_dryrun_small.py
# and xlstm-125m: (arch, mode, batch, seq) on a (4, 2) fake mesh
DRYRUN_CASES = (("internlm2-1.8b", "train", 8, 64),
                ("jamba-v0.1-52b", "train", 8, 64),
                ("xlstm-125m", "train", 8, 64),
                ("deepseek-v2-236b", "decode", 8, 128),
                ("whisper-medium", "prefill", 8, 64))
FLASH_GEMMA2 = (2, 8, 4, 8192, 256)      # windows 4,096 (local), -1; cap 50
FLASH_QWEN2 = (8, 28, 4, 512, 128)       # a GQA group of 7


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def check_free(leg: str, peak: int) -> int:
    """A leg's peak (bytes) must leave MOE_FREE_BYTES_MIN of the card
    free; returns the card's bytes."""
    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    check(total - peak >= MOE_FREE_BYTES_MIN, f"{leg}: peak {peak} of "
          f"{total} bytes leaves less than {MOE_FREE_BYTES_MIN} free")
    return total


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def relu_like(shape, generator, tau=0.05):
    """ReLU output (about half exact zeros) with values at and beside the
    float32 tau and a few negative zeros, where the comparisons decide."""
    import torch
    x = torch.relu(torch.randn(shape, generator=generator,
                               device=generator.device) * 0.2)
    flat = x.view(-1)
    t = torch.tensor(tau, dtype=torch.float32, device=x.device)
    edges = torch.stack([t, torch.nextafter(t, torch.zeros_like(t)),
                         torch.nextafter(t, torch.ones_like(t)),
                         torch.zeros_like(t).neg()])
    idx = torch.randint(0, flat.numel(), (4096,), generator=generator,
                        device=x.device)
    flat[idx] = edges.repeat(1024)
    return x


def bound(bytes_moved, ops_done, peak=F32_OPS_PER_S):
    """The least time for the work, in ms, and what bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops_done / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_ms(fn, inputs, reps: int = 60) -> float:
    """Device time of one call, from CUDA events around ``reps`` calls that
    rotate over ``inputs`` (together larger than the 50 MB L2, so each call
    reads device memory).  The card first sleeps while the host enqueues
    every call, so host overhead leaves no gaps between them."""
    import torch
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def lm_activation(shape, generator, dtype):
    """Unit-scale activations (as a final RMS norm emits them) with exact
    zeros and the bfloat16 values on both sides of tau = 0.05, where the
    float32 comparison decides."""
    import torch
    x = torch.randn(shape, generator=generator, device=generator.device)
    flat = x.view(-1)
    n = flat.numel()
    edges = torch.tensor([0.0, -0.0, 0.05, 0.0498046875, 0.050048828125,
                          -0.0498046875, -0.050048828125],
                         device=x.device)
    idx = torch.randint(0, n, (7 * 512,), generator=generator,
                        device=x.device)
    flat[idx] = edges.repeat(512)
    return x.to(dtype)


def phase_environment(build) -> str:
    import importlib.util

    import torch
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    triton = None
    if importlib.util.find_spec("triton") is not None:
        import triton
        triton = triton.__version__
    emit(phase="environment", python=sys.version.split()[0],
         torch=torch.__version__, torch_cuda=torch.version.cuda,
         triton=triton,
         nvcc=run([build._nvcc(), "--version"]).splitlines()[-1],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def phase_build(build) -> None:
    t0 = time.perf_counter()
    paths = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in
                    build.log_path(name).read_text().splitlines()
                    if "registers" in line or "spill" in line]
             for name in paths}
    emit(phase="build", seconds=seconds,
         libraries=[str(p.relative_to(ROOT)) for p in paths.values()],
         ptxas=ptxas)


def signature_routes(sig, x, tau, mean=False):
    """The kernel's output on ``x`` by the route ``sig.route`` picks, and,
    where that is ``"vec"``, by the strided kernel on the same input too."""
    import torch
    out = [(sig.route(x), sig.signature_counts(x, tau, mean=mean))]
    if out[0][0] == "vec":
        strided = torch.empty_like(out[0][1])
        out.append(("strided", sig._dispatch(x, strided, "strided", tau,
                                             mean)))
    return out


def phase_kernels(sig, ops, dev) -> dict:
    """Kernel against plain version, bit for bit, on both routes; then
    times at the CNN path's shape."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    compared = []
    for shape in (MAIN_SHAPE, RAGGED_SHAPE):
        for tau in (0.0, 0.05):
            x = relu_like(shape, g)
            strided = x.transpose(1, 2).contiguous().transpose(1, 2)
            pairs = [(r, got, sig.signature_counts_plain(x, tau))
                     for r, got in signature_routes(sig, x, tau)]
            pairs += [(r, got, sig.signature_counts_plain(x, tau))
                      for r, got in signature_routes(sig, strided, tau)]
            pairs += [(r, got, sig.signature_counts_plain(x, tau, mean=True))
                      for r, got in signature_routes(sig, x, tau, True)]
            pairs.append((sig.route(x[0][None]),
                          sig.signature_td(x[0], tau=tau),
                          sig.signature_td_plain(x[0], tau=tau)))
            torch.cuda.synchronize()
            for r, got, want in pairs:
                check(got.is_cuda and got.shape == want.shape,
                      f"signature kernel output at {shape}, tau {tau}")
                err = (got - want).abs().max().item()
                max_err = max(max_err, err)
                check(torch.equal(got, want),
                      f"signature kernel ({r}) != plain at {shape}, tau "
                      f"{tau}: max |diff| {err}")
            compared.append({"shape": list(shape), "tau": tau,
                             "routes": sorted({r for r, _, _ in pairs})})
    # the model-facing wrapper on a channels-last activation
    act = relu_like((16, 64, 32, 32), g).to(memory_format=torch.channels_last)
    nhwc = act.permute(0, 2, 3, 1)
    check(sig.route(nhwc.reshape(16, -1, 64)) == "vec",
          "a channels-last activation does not take the vec route")
    got = ops.signature_per_channel(nhwc)
    want = (sig.signature_counts_plain(nhwc.reshape(16, -1, 64), 0.0)
            * float(1 / 1024))
    check(torch.equal(got, want), "signature_per_channel on the card")

    inputs = [relu_like(MAIN_SHAPE, g) for _ in range(4)]
    library_ms = device_ms(lambda x: MAIN_SHAPE[1]
                           - torch.count_nonzero(x, dim=1), inputs)
    cnn = signature_timing(sig, "cnn", inputs, 0.0, library_ms)
    record = {"name": "signature_counts", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/signature.cu",
              "replaces": "src/repro/kernels/signature.py:45",
              "max_abs_err": max_err, "ms": cnn["ms"],
              "plain_ms": cnn["plain_ms"], "bound_ms": cnn["bound_ms"],
              "bound_by": cnn["bound_by"], "library_ms": library_ms,
              "timed_shape": list(MAIN_SHAPE), "widths": [cnn]}
    emit(phase="kernels_vs_plain", compared=compared, **cnn)
    return record


def signature_timing(sig, path, inputs, tau, library_ms=None) -> dict:
    """The signature kernel's time on ``inputs`` by its route, the strided
    kernel's on the same inputs, the plain version's, and the bound."""
    import torch
    x = inputs[0]
    n, t, c = x.shape
    which = sig.route(x)
    ms = device_ms(lambda a: sig.signature_counts(a, tau), inputs)
    out = torch.empty((n, c), device=x.device)
    strided_ms = device_ms(lambda a: sig._dispatch(a, out, "strided", tau,
                                                   False), inputs)
    plain_ms = device_ms(lambda a: sig.signature_counts_plain(a, tau),
                         inputs, reps=20)
    bound_ms, bound_by = bound(n * t * c * x.element_size() + n * c * 4,
                               2 * n * t * c)   # one compare, one add
    return {"path": path, "shape": [n, t, c], "dtype": str(x.dtype),
            "tau": tau, "route": which, "ms": ms, "strided_ms": strided_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_signature_lm(sig, ops, dev) -> list:
    """The signature kernel on bfloat16 and float32 input, on both routes
    and in the bucketed form of the LM-family paths, bit for bit; then
    timed at each LM-family path's width."""
    import torch
    from repro_torch.models.layers import activation_signature
    g = torch.Generator(device=dev).manual_seed(3)
    compared = []
    for shape in (*SIG_WIDTHS.values(), *LM_SIG_RAGGED):
        for dtype in (torch.bfloat16, torch.float32):
            x = lm_activation(shape, g, dtype)
            routes = set()
            for tau in (0.0, 0.05):
                want = sig.signature_counts_plain(x, tau)
                for r, got in signature_routes(sig, x, tau):
                    torch.cuda.synchronize()
                    routes.add(r)
                    check(torch.equal(got, want),
                          f"signature kernel ({r}) != plain at {shape} "
                          f"{dtype} tau {tau}")
            got = ops.signature(x, tau=0.05, n_sig=64)
            want = activation_signature(x, n_sig=64, tau=0.05)
            check(torch.equal(got, want) and torch.equal(
                got.cpu(), ops.signature(x.cpu(), tau=0.05, n_sig=64)),
                f"bucketed signature != plain at {shape} {dtype}")
            compared.append({"shape": list(shape), "dtype": str(dtype),
                             "routes": sorted(routes)})
    # the cohort legs' per-sample rows: the counts over (B, S, d) on both
    # routes, and the rows against the plain per-row signature (the
    # reference's vmap of ``signature``), bit for bit
    for leg, shape in SIG_PER_SAMPLE.items():
        x = lm_activation(shape, g, torch.bfloat16)
        want = sig.signature_counts_plain(x, 0.05)
        routes = set()
        for r, got in signature_routes(sig, x, 0.05):
            torch.cuda.synchronize()
            routes.add(r)
            check(torch.equal(got, want), f"signature kernel ({r}) != plain "
                  f"at {leg}'s {shape}")
        got = ops.signature_per_sample(x, tau=0.05, n_sig=64)
        want = torch.stack([activation_signature(row, n_sig=64, tau=0.05)
                            for row in x])
        check(torch.equal(got, want), f"per-sample signature rows != plain "
              f"at {leg}'s {shape}")
        compared.append({"shape": list(shape), "dtype": "torch.bfloat16",
                         "path": leg, "per_sample_rows": True,
                         "routes": sorted(routes)})
    widths = []
    for path, shape in SIG_WIDTHS.items():
        size = shape[0] * shape[1] * shape[2] * 2
        inputs = [lm_activation(shape, g, torch.bfloat16)
                  for _ in range(max(6, -(-120_000_000 // size)))]
        timing = signature_timing(sig, path, inputs, 0.05)
        timing["bucketed_ms"] = device_ms(
            lambda x: ops.signature(x, tau=0.05, n_sig=64), inputs)
        widths.append(timing)
        del inputs
    emit(phase="signature_lm_vs_plain", compared=compared, widths=widths)
    return widths


def phase_flash(fa, ops, dev) -> dict:
    """The flash attention kernels against their plain versions on the
    card: every bfloat16 case on the Hopper route (``sm90``) within the
    reference's 2e-2 of ``flash_attention_plain`` and within FLASH_TC_TOL
    of ``flash_attention_tc_plain``, every float32 case on the FMA route
    within 2e-5; then timed at the LM and hybrid paths' shapes beside the
    FMA kernel on the same bfloat16 inputs and the library's
    scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(2)
    max_err = {"float32": 0.0, "bfloat16": 0.0, "bfloat16_tc": 0.0}
    compared = []

    def compare(q, k, v, causal, window, cap, what, kv_heads=None):
        """The kernel on all heads; the plain versions on every head, a
        group of ``kv_heads`` KV heads and their query heads at a time
        (all at once by default), where the whole (S, S) scores of every
        head would not fit beside them."""
        dtype = str(q.dtype).split(".")[-1]
        want_route = "sm90" if q.dtype == torch.bfloat16 else "fma"
        before = (fa.launches_sm90, fa.launches_fma)
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cap)
        routes = (fa.launches_sm90 - before[0], fa.launches_fma - before[1])
        check(routes == ((1, 0) if want_route == "sm90" else (0, 1)),
              f"flash at {what} {dtype}: launches by route (sm90, fma) "
              f"{routes}, expected the {want_route} route")
        torch.cuda.synchronize()
        check(got.is_cuda and got.shape == q.shape and got.dtype == q.dtype
              and got.is_contiguous(), f"flash output at {what}")
        K = k.shape[2]
        group = K if kv_heads is None else kv_heads
        per = q.shape[2] // K                  # query heads a KV head
        tol = FLASH_TOL[dtype]
        err = tc_err = 0.0
        for g0 in range(0, K, group):
            heads = slice(g0 * per, (g0 + group) * per)
            kv = slice(g0, g0 + group)
            bhsd = [t.transpose(1, 2) for t in (q[:, :, heads], k[:, :, kv],
                                                v[:, :, kv])]
            part = got[:, :, heads].float()
            want = fa.flash_attention_plain(
                *bhsd, causal=causal, window=window,
                softcap=cap).transpose(1, 2).float()
            diff = (part - want).abs()
            err = max(err, diff.max().item())
            check(bool((diff <= tol + tol * want.abs()).all()),
                  f"flash kernel != plain at {what} {dtype}, KV heads "
                  f"{g0}-{g0 + group - 1}: max |diff| {err}")
            del want, diff
            if want_route == "sm90":
                tc = fa.flash_attention_tc_plain(
                    *bhsd, causal=causal, window=window,
                    softcap=cap).transpose(1, 2).float()
                diff = (part - tc).abs()
                tc_err = max(tc_err, diff.max().item())
                check(bool((diff <= FLASH_TC_TOL["atol"]
                            + FLASH_TC_TOL["rtol"] * tc.abs()).all()),
                      f"flash kernel != tc plain at {what}, KV heads "
                      f"{g0}-{g0 + group - 1}: max |diff| {tc_err}")
                del tc, diff
            del part
        max_err[dtype] = max(max_err[dtype], err)
        case = {"case": what, "dtype": dtype, "route": want_route,
                "max_abs_err": err, "heads_compared": q.shape[2]}
        if want_route == "sm90":
            max_err["bfloat16_tc"] = max(max_err["bfloat16_tc"], tc_err)
            case["max_abs_err_tc"] = tc_err
        compared.append(case)

    # the paths' shapes: 512 (LM), 1,024 (hybrid) and 512 (hybrid cohort,
    # batch 4) work items of the persistent grid, as q, k, v of their own
    # (as the models project them) and as views into one fused qkv
    for path, shape in (("LM", FLASH_MAIN), ("hybrid", FLASH_HYBRID),
                        ("hybrid cohort", FLASH_HYBRID_COHORT)):
        B, H, K, S, hd = shape
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev)
                   .to(torch.bfloat16) for n in (H, K, K))
        compare(q, k, v, True, -1, 0.0, f"{path} path {list(shape)}")
        qkv = torch.randn((B, S, H + 2 * K, hd), generator=g,
                          device=dev).to(torch.bfloat16)
        compare(qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:], True,
                -1, 0.0, f"{path} path {list(shape)}, fused qkv view")
    # the serve path's float32 check prefills at the LM and hybrid shapes
    # on the FMA kernel
    for path, shape in (("LM", FLASH_MAIN), ("hybrid", FLASH_HYBRID)):
        B, H, K, S, hd = shape
        q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev)
                   for n in (H, K, K))
        compare(q, k, v, True, -1, 0.0, f"{path} path {list(shape)}")
    for case in FLASH_CASES + [FLASH_HD256]:
        b, h, kh, s, d, causal, window, cap = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev)
                       .to(dtype) for n in (h, kh, kh))
            compare(q, k, v, causal, window, cap, list(case))
    # the attention variants: MLA's head dim 192 at its path's shape on
    # both routes (the float32 check runs its prefill on the FMA kernel);
    # gemma3's 8,192 tokens with its local window and without (the plain
    # versions one KV head and its query heads at a time); a ragged S past
    # 4,096; the dense configs: gemma2's head dim 256 at 8,192 tokens with
    # its window of 4,096 and without, soft-capped at 50, and qwen2's GQA
    # group of 7, on both routes (their float32 checks run on the FMA
    # kernel)
    both = (torch.bfloat16, torch.float32)
    for shape, window, cap, dtypes, kv_heads in (
            (FLASH_MLA, -1, 0.0, both, 32),
            (FLASH_WHISPER, -1, 0.0, both, None),
            (FLASH_GEMMA3, 1024, 0.0, (torch.bfloat16,), 1),
            (FLASH_GEMMA3, -1, 0.0, (torch.bfloat16,), 1),
            (FLASH_RAGGED_LONG, 1024, 0.0, both, None),
            (FLASH_RAGGED_LONG, -1, 0.0, both, None),
            (FLASH_GEMMA2, 4096, 50.0, both, 1),
            (FLASH_GEMMA2, -1, 50.0, both, 1),
            (FLASH_QWEN2, -1, 0.0, both, None)):
        B, H, K, S, hd = shape
        for dtype in dtypes:
            q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev)
                       .to(dtype) for n in (H, K, K))
            compare(q, k, v, True, window, cap,
                    f"{list(shape)} window {window} cap {cap}", kv_heads)
            del q, k, v

    def timed(shape, window=-1, reps=60, slow_reps=10, cap=0.0):
        """The kernel's time at ``shape`` (causal, ``window``, soft-cap
        ``cap``) beside the FMA kernel's on the same bfloat16 inputs, the
        plain version's and the library's scaled_dot_product_attention
        (with an explicit mask for a window; it has no soft-cap, so with
        ``cap`` it computes the uncapped scores); the slower ones over
        ``slow_reps`` calls."""
        B, H, K, S, hd = shape
        sets = [tuple(torch.randn((B, S, n, hd), generator=g, device=dev)
                      .to(torch.bfloat16) for n in (H, K, K))
                for _ in range(4)]
        bhsd = [tuple(t.transpose(1, 2) for t in st) for st in sets]
        packed = [tuple(t.contiguous() for t in st) for st in bhsd]

        def fma(a):                    # the FMA kernel on the same inputs
            return fa._dispatch(*a, torch.empty_like(a[0]), "fma", True,
                                window, cap)

        if window > 0:
            rows = torch.arange(S, device=dev)[:, None]
            cols = torch.arange(S, device=dev)[None, :]
            mask = (rows >= cols) & (rows - cols < window)

            def library(a):
                return F.scaled_dot_product_attention(
                    *a, attn_mask=mask, enable_gqa=True)
        else:
            def library(a):
                return F.scaled_dot_product_attention(
                    *a, is_causal=True, enable_gqa=True)

        ms = device_ms(lambda a: ops.flash_attention(
            *a, window=window, softcap=cap), sets, reps)
        fma_ms = device_ms(fma, bhsd, slow_reps)
        plain_ms = device_ms(lambda a: fa.flash_attention_plain(
            *a, window=window, softcap=cap), bhsd[:1], slow_reps)
        library_ms = device_ms(library, packed, slow_reps)
        bytes_moved = sum(t.numel() * t.element_size() for t in sets[0]) \
            + sets[0][0].numel() * 2
        w = S if window <= 0 else min(window, S)
        pairs = w * (w + 1) // 2 + (S - w) * w   # (row, col) pairs kept
        flops = 2 * 2 * hd * pairs * B * H       # QK^T and PV, 2 per MAC
        bound_ms, bound_by = bound(bytes_moved, flops, peak=BF16_OPS_PER_S)
        del sets, bhsd, packed
        return {"timed_shape": list(shape), "timed_dtype": "bfloat16",
                "window": window, "softcap": cap,
                "library_without_cap": cap > 0.0, "ms": ms,
                "fma_ms": fma_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "bytes": bytes_moved, "flops": flops}

    main = timed(FLASH_MAIN)
    hybrid = timed(FLASH_HYBRID)
    variants = {"gemma3_local": timed(FLASH_GEMMA3, 1024, 20, 3),
                "gemma3_global": timed(FLASH_GEMMA3, -1, 20, 3),
                "mla": timed(FLASH_MLA, -1, 20, 5),
                "whisper": timed(FLASH_WHISPER),
                "gemma2_local": timed(FLASH_GEMMA2, 4096, 20, 3, cap=50.0),
                "gemma2_global": timed(FLASH_GEMMA2, -1, 20, 3, cap=50.0),
                "qwen2": timed(FLASH_QWEN2)}
    record = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
              "fma_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:86",
              "max_abs_err": max(max_err["float32"], max_err["bfloat16"]),
              "max_abs_err_float32": max_err["float32"],
              "max_abs_err_bfloat16": max_err["bfloat16"],
              "max_abs_err_bfloat16_tc": max_err["bfloat16_tc"],
              **{k: v for k, v in main.items()
                 if k not in ("bytes", "flops")},
              "hybrid": {k: v for k, v in hybrid.items()
                         if k not in ("bytes", "flops")},
              **{name: {k: v for k, v in t.items() if k != "bytes"}
                 for name, t in variants.items()}}
    # the float32-core floor is derived, not measured: it stays out of the
    # kernels line and is printed only with this phase
    emit(phase="flash_vs_plain", compared=len(compared), cases=compared,
         bytes=main["bytes"], flops=main["flops"],
         f32_core_ms=main["flops"] / F32_OPS_PER_S * 1e3, **record)
    return record


def scan_inputs(shape, generator, proj_width=None, h0_scale=0.1):
    """x, dt, A, Bc, Cc, h0 as the reference's kernel tests draw them (dt
    through a softplus, A negative).  With ``proj_width``, Bc and Cc are
    views into one (B, S, proj_width + 2N) projection, as ``models.mamba``
    splits them (row stride ``dt_rank + 2N``)."""
    import torch
    import torch.nn.functional as F
    B, S, d_in, N = shape
    dev = generator.device

    def normal(*size):
        return torch.randn(size, generator=generator, device=dev)

    x = normal(B, S, d_in)
    dt = F.softplus(normal(B, S, d_in))
    A = -torch.exp(normal(d_in, N) * 0.5)
    if proj_width is None:
        Bc, Cc = normal(B, S, N), normal(B, S, N)
    else:
        proj = normal(B, S, proj_width + 2 * N)
        Bc, Cc = proj[..., proj_width:proj_width + N], proj[..., -N:]
    h0 = normal(B, d_in, N) * h0_scale
    return x, dt, A, Bc, Cc, h0


def phase_scan(ss, ops, dev) -> dict:
    """The selective scan kernel against its plain version on the card,
    within the reference's 1e-5; then timed at the hybrid path's shape."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4)
    max_err = 0.0
    compared = []

    def compare(got, want, what):
        nonlocal max_err
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("y", "h_last"), got, want):
            check(a.is_cuda and a.shape == b.shape and a.dtype == b.dtype,
                  f"scan {name} at {what}")
            err = (a - b).abs().max().item() if a.numel() else 0.0
            errs.append(err)
            check(bool(((a - b).abs() <= SCAN_TOL + SCAN_TOL * b.abs())
                       .all()),
                  f"scan kernel != plain at {what}, {name}: max |diff| "
                  f"{err}")
        max_err = max(max_err, *errs)
        compared.append({"case": what, "y_max_abs_err": errs[0],
                         "h_max_abs_err": errs[1]})

    cases = [(list(c), scan_inputs(c, g)) for c in SCAN_CASES]
    cases.append(("main path, strided B and C",
                  scan_inputs(SCAN_MAIN, g, proj_width=256)))
    cases.append(("hybrid cohort, batch 4, strided B and C",
                  scan_inputs(SCAN_HYBRID_COHORT, g, proj_width=256)))
    cases.append(("ragged, non-zero h0",
                  scan_inputs(SCAN_RAGGED, g, proj_width=5, h0_scale=1.0)))
    for what, inputs in cases:
        got = ops.selective_scan(*inputs)
        compare(got, ss.selective_scan_plain(*inputs), str(what))
        # and against the plain version of the kernel's own arithmetic
        compare(got, ss.selective_scan_split_plain(*inputs),
                f"{what}, split plain")
    # two calls carrying the state against one over the whole
    x, dt, A, Bc, Cc, h0 = scan_inputs((2, 80, 300, 16), g, proj_width=7)
    y1, h1 = ss.selective_scan_bsd(x[:, :43], dt[:, :43], A, Bc[:, :43],
                                   Cc[:, :43], h0)
    y2, h2 = ss.selective_scan_bsd(x[:, 43:], dt[:, 43:], A, Bc[:, 43:],
                                   Cc[:, 43:], h1)
    compare((torch.cat([y1, y2], 1), h2),
            ss.selective_scan_plain(x, dt, A, Bc, Cc, h0),
            "state continuation over two calls")

    sets = [scan_inputs(SCAN_MAIN, g, proj_width=256) for _ in range(3)]
    ms = device_ms(lambda a: ss.selective_scan_bsd(*a), sets)
    plain_ms = device_ms(lambda a: ss.selective_scan_plain(*a), sets,
                         reps=6)
    B, S, d_in, N = SCAN_MAIN
    bytes_moved = 4 * (3 * B * S * d_in       # x, dt read; y written
                       + 2 * B * d_in * N     # h0 read, h_last written
                       + d_in * N             # A
                       + 2 * B * S * N)       # Bc, Cc
    steps = B * S * d_in * N
    # per (b, t, c, n): dt*A, exp, da*h, dx*B, +, h*C, +; per (b, t, c):
    # dt*x
    ops_done = 7 * steps + B * S * d_in
    bound_ms, bound_by = bound(bytes_moved, ops_done)
    record = {"name": "selective_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
              "replaces": "src/repro/kernels/selective_scan.py:50",
              "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": None,
              "library_none": "no single PyTorch call computes a "
                              "selective scan",
              "timed_shape": list(SCAN_MAIN)}
    # the exponentials' floor on the special-function units is derived,
    # not measured: it stays out of the kernels line
    x, dt, A = sets[0][:3]
    emit(phase="scan_vs_plain", compared=len(compared), cases=compared,
         bytes=bytes_moved, flops=ops_done,
         exp_units_ms=steps / (SFU_EXP_PER_CLOCK_SM * H100_SMS
                               * H100_BOOST_HZ) * 1e3,
         max_abs_dt_A=(dt.amax(dim=(0, 1)) * A.abs().amax(1)).max().item(),
         **record)
    return record


def mlstm_inputs(shape, generator, dtype):
    """q, k, v and the gates as the reference's kernel tests draw them
    (forget gates shifted by +2); the gates as the two halves of one
    (B, S, 2H) projection, as ``models.xlstm`` splits them."""
    import torch
    B, S, H, dk, dv = shape
    dev = generator.device

    def normal(*size):
        return torch.randn(size, generator=generator, device=dev)

    q, k, v = (normal(B, S, H, n).to(dtype) for n in (dk, dk, dv))
    gif = normal(B, S, 2 * H)
    gif[..., H:] += 2.0
    return (q, k, v) + tuple(gif.chunk(2, dim=-1))


def mlstm_flops(B, S, H, dk, dv, L) -> int:
    """Float32 operations of the chunkwise form at chunk length L: per
    chunk the causal q k^T and W v, then q C, q n, k^T v and k^T 1 across
    chunks, and the carry's scaling (2 per multiply-add)."""
    chunks = -(-S // L)
    per_chunk = (L * (L + 1) * (dk + dv) + 4 * L * dk * dv + 4 * L * dk
                 + dk * dv)
    return B * H * chunks * per_chunk


def phase_mlstm(ml, ops, dev) -> dict:
    """The chunkwise mLSTM kernel against its plain versions on the card
    (the reference's chunk loop and the kernel's own two-pass form), within
    the reference's 1e-4; then timed at the xLSTM path's shape."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    max_err = 0.0
    compared = []
    cases = [((B, S, H, dk, dv), chunk, torch.float32)
             for B, S, H, dk, dv, chunk in MLSTM_CASES]
    cases += [(MLSTM_MAIN, 256, torch.bfloat16),
              (MLSTM_MAIN, 256, torch.float32),     # serve path's float32
              (MLSTM_RAGGED[:5], MLSTM_RAGGED[5], torch.float32),
              (MLSTM_RAGGED[:5], MLSTM_RAGGED[5], torch.bfloat16)]
    for shape, chunk, dtype in cases:
        what = f"{list(shape)} chunk {chunk} {str(dtype)[6:]}"
        inputs = mlstm_inputs(shape, g, dtype)
        h, state = ops.mlstm_chunkwise(*inputs, chunk=chunk,
                                       h_dtype=torch.float32)
        errs = {}
        for plain, (h_want, st_want) in (
                ("plain", ml.mlstm_chunkwise_plain(*inputs, chunk=chunk)),
                ("two_pass", ml.mlstm_two_pass_plain(*inputs))):
            torch.cuda.synchronize()
            errs[plain] = {}
            for name, a, b in [("h", h, h_want)] + [
                    (n, state[n], st_want[n]) for n in ("C", "n", "m")]:
                check(a.is_cuda and a.shape == b.shape
                      and a.dtype == b.dtype, f"mLSTM {name} at {what}")
                err = (a - b).abs().max().item()
                errs[plain][name] = err
                check(bool(((a - b).abs() <= MLSTM_TOL + MLSTM_TOL * b.abs())
                           .all()),
                      f"mLSTM kernel != {plain} at {what}, {name}: max "
                      f"|diff| {err}")
        max_err = max(max_err, errs["plain"]["h"])
        compared.append({"case": what, "max_abs_err": errs})
    sets = [mlstm_inputs(MLSTM_MAIN, g, torch.bfloat16) for _ in range(3)]
    ms = device_ms(lambda a: ml.mlstm_chunkwise_bshd(*a), sets)
    # the device time of each of the kernel's three launches, a call
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in sets:
            ml.mlstm_chunkwise_bshd(*a)
        torch.cuda.synchronize()
    pass_ms = {name: sum(e.self_device_time_total for e in prof.key_averages()
                         if f"mlstm_{name}_kernel" in e.key) / 1e3 / len(sets)
               for name in ("scores", "state", "output")}
    plain_ms = device_ms(lambda a: ml.mlstm_chunkwise_plain(*a, chunk=256),
                         sets, reps=12)
    B, S, H, dk, dv = MLSTM_MAIN
    bytes_moved = (2 * (2 * B * S * H * dk + B * S * H * dv)   # q, k, v bf16
                   + 4 * (2 * B * S * H                        # gates
                          + B * S * H * dv                     # h
                          + B * H * dk * dv + B * H * dk + B * H))  # C, n, m
    # the bound counts the chunkwise form's work at 32-step chunks, one
    # yardstick for every design of the kernel; the work at the kernel's
    # own chunk is counted beside it
    flops = mlstm_flops(B, S, H, dk, dv, MLSTM_BOUND_CHUNK)
    bound_ms, bound_by = bound(bytes_moved, flops)
    kernel_flops = mlstm_flops(B, S, H, dk, dv, ml.KERNEL_CHUNK)
    record = {"name": "mlstm_chunkwise", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/mlstm.cu",
              "replaces": "src/repro/kernels/mlstm.py:96",
              "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
              "library_none": "no single PyTorch call computes the mLSTM "
                              "recurrence",
              "timed_shape": list(MLSTM_MAIN), "timed_dtype": "bfloat16"}
    # the counts at other chunks are derived, not measured: they stay out
    # of the kernels line
    emit(phase="mlstm_vs_plain", compared=len(compared), cases=compared,
         pass_ms=pass_ms, bytes=bytes_moved, flops=flops,
         bound_chunk=MLSTM_BOUND_CHUNK,
         kernel_chunk=ml.KERNEL_CHUNK, flops_at_kernel_chunk=kernel_flops,
         bound_ms_at_kernel_chunk=bound(bytes_moved, kernel_flops)[0],
         flops_at_chunk_256=mlstm_flops(B, S, H, dk, dv, 256), **record)
    return record


def slstm_inputs(shape, generator, fresh=True, r_scale=SLSTM_R_SCALE):
    """gates_x, R (N(0, 1) x ``r_scale``) and a fresh or a carried
    state."""
    import torch
    B, S, d = shape
    dev = generator.device

    def normal(*size):
        return torch.randn(size, generator=generator, device=dev)

    gx, R = normal(B, S, 4 * d), normal(d, 4 * d) * r_scale
    if fresh:
        zeros = torch.zeros((B, d), device=dev)
        return gx, R, zeros, zeros, zeros, torch.full((B, d), -1e30,
                                                      device=dev)
    return (gx, R, normal(B, d), 1.0 + torch.rand((B, d), generator=generator,
                                                  device=dev),
            normal(B, d) * 0.5, normal(B, d))


def phase_slstm(sl, ops, dev) -> dict:
    """The sLSTM recurrence kernel against its plain version on the card,
    hs within the reference's 1e-5 and the states within 1e-4; then timed
    at the xLSTM path's shape."""
    import torch
    g = torch.Generator(device=dev).manual_seed(6)
    max_err = {"hs": 0.0, "state": 0.0}
    compared = []

    def compare(got, want, what):
        (hs, st), (hs_want, st_want) = got, want
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in [("hs", hs, hs_want)] + [
                (n, a, b) for n, a, b in zip("cnhm", st, st_want)]:
            tol = SLSTM_TOL["hs" if name == "hs" else "state"]
            check(a.is_cuda and a.shape == b.shape and a.dtype == b.dtype,
                  f"sLSTM {name} at {what}")
            errs[name] = (a - b).abs().max().item()
            check(bool(((a - b).abs() <= tol + tol * b.abs()).all()),
                  f"sLSTM kernel != plain at {what}, {name}: max |diff| "
                  f"{errs[name]}")
        max_err["hs"] = max(max_err["hs"], errs["hs"])
        max_err["state"] = max(max_err["state"],
                               *(errs[n] for n in "cnhm"))
        compared.append({"case": what, "max_abs_err": errs})

    model = SLSTM_MODEL_R_SCALE
    cases = [(list(c), slstm_inputs(c, g)) for c in SLSTM_CASES]
    cases.append(("main path", slstm_inputs(SLSTM_MAIN, g, r_scale=model)))
    cases.append(("main path, carried state",
                  slstm_inputs(SLSTM_MAIN, g, fresh=False, r_scale=model)))
    cases.append(("ragged d, carried state",
                  slstm_inputs(SLSTM_RAGGED[0], g, fresh=False)))
    cases.append(("wide ragged d, carried state",
                  slstm_inputs(SLSTM_RAGGED[1], g, fresh=False,
                               r_scale=model)))
    for shape in SLSTM_BATCHES:
        cases.append((f"batch {shape[0]}, carried state",
                      slstm_inputs(shape, g, fresh=False, r_scale=model)))
    launched = {}
    for what, inputs in cases:
        before = sl.launches
        compare(ops.slstm_scan(*inputs), sl.slstm_scan_plain(*inputs),
                str(what))
        launched[str(what)] = sl.launches - before
    for shape in SLSTM_BATCHES:
        check(launched[f"batch {shape[0]}, carried state"] == 1,
              f"sLSTM at batch {shape[0]} took "
              f"{launched[f'batch {shape[0]}, carried state']} launches")
    # the drift at the reference's R scale and the main shape: the kernel
    # and the float32 plain version, each against the plain version in
    # float64
    inputs = slstm_inputs(SLSTM_MAIN, g)
    hs64, st64 = sl.slstm_scan_plain(*(t.double() for t in inputs))
    drift = {}
    for name, (hs, st) in (("kernel", sl.slstm_scan_bsd(*inputs)),
                           ("plain", sl.slstm_scan_plain(*inputs))):
        drift[name] = {
            "hs": (hs.double() - hs64).abs().max().item(),
            "hs_last_step": (hs[:, -1].double() - hs64[:, -1]).abs().max()
            .item(),
            "state": max((a.double() - b).abs().max().item()
                         for a, b in zip(st, st64))}
    del hs64, st64, inputs
    # two calls carrying the state against one over the whole
    gx, R, c0, n0, h0, m0 = slstm_inputs((2, 80, 96), g)
    hs1, st1 = sl.slstm_scan_bsd(gx[:, :43], R, c0, n0, h0, m0)
    hs2, st2 = sl.slstm_scan_bsd(gx[:, 43:], R, *st1)
    compare((torch.cat([hs1, hs2], 1), st2),
            sl.slstm_scan_plain(gx, R, c0, n0, h0, m0),
            "state continuation over two calls")

    sets = [slstm_inputs(SLSTM_MAIN, g, r_scale=model) for _ in range(2)]
    ms = device_ms(lambda a: sl.slstm_scan_bsd(*a), sets, reps=20)
    # the same grid and step loop without the h @ R products: the exchange
    # of h between blocks, the gating and the barriers alone
    floor_ms = device_ms(lambda a: sl.exchange_floor(*a), sets, reps=20)
    plain_ms = device_ms(lambda a: sl.slstm_scan_plain(*a), sets, reps=4)
    batch_ms = {}
    for shape in SLSTM_BATCHES:
        bsets = [slstm_inputs(shape, g, r_scale=model) for _ in range(2)]
        batch_ms[str(shape[0])] = {
            "shape": list(shape),
            "ms": device_ms(lambda a: sl.slstm_scan_bsd(*a), bsets, reps=10)}
        batch_ms[str(shape[0])]["us_per_step"] = (
            batch_ms[str(shape[0])]["ms"] * 1e3 / shape[1])
        del bsets
    B, S, d = SLSTM_MAIN
    bytes_moved = 4 * (B * S * 4 * d + d * 4 * d     # gates_x, R
                       + 4 * B * d + 4 * B * d       # states in and out
                       + B * S * d)                  # hs
    # h @ R (2 per multiply-add), the four gate adds and the gating's 17
    # operations (3 exp, tanh, the exact sigmoid, max, ...) per unit-step
    flops = 2 * B * S * d * 4 * d + (4 + 17) * B * S * d
    bound_ms, bound_by = bound(bytes_moved, flops)
    record = {"name": "slstm_scan", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/slstm.cu",
              "replaces": "src/repro/kernels/slstm.py:77",
              "max_abs_err": max_err["hs"],
              "max_abs_err_state": max_err["state"], "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "library_none": "no single PyTorch call computes the sLSTM "
                              "recurrence",
              "timed_shape": list(SLSTM_MAIN),
              "us_per_step": ms * 1e3 / S,
              "exchange_floor_ms": floor_ms,
              "exchange_floor_us_per_step": floor_ms * 1e3 / S}
    props = torch.cuda.get_device_properties(dev)
    emit(phase="slstm_vs_plain", compared=len(compared), cases=compared,
         launches_by_case=launched, drift_vs_float64_at_r_scale_005=drift,
         bytes=bytes_moved, flops=flops, batches=batch_ms,
         grid_blocks=-(-d // sl.units_per_block(
             d, props.multi_processor_count)),
         **record)
    return record


def reference_check(cnn, cfg, dev, params) -> dict:
    """The card's VGG16 forward against the port's CPU forward on a small
    input, from the same weights: logits within float32 convolution noise,
    signatures within a few ReLU sign flips."""
    import torch
    from repro_torch.core.aggregate import tree_map
    x = relu_like((8, 32, 32, 3), torch.Generator(device=dev).manual_seed(1),
                  tau=0.5) - 0.25
    with torch.inference_mode():
        logits, sig = cnn.cnn_forward(params, x, cfg, want_signature=True)
        cpu_params = tree_map(lambda p: p.cpu(), params)
        ref_logits, ref_sig = cnn.cnn_forward(cpu_params, x.cpu(), cfg,
                                              want_signature=True)
    logit_err = (logits.cpu() - ref_logits).abs().max().item()
    sig_err = (sig.cpu() - ref_sig).abs().max().item()
    scale = ref_logits.abs().max().item()
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    check(logit_err <= 1e-3 * max(scale, 1.0),
          f"card logits differ from CPU by {logit_err} (scale {scale})")
    check(sig_err <= 0.01, f"card signature differs from CPU by {sig_err}")
    return {"logits_max_abs_err": logit_err, "logits_scale": scale,
            "signature_max_abs_err": sig_err}


def cnn_world():
    """VGG16 at full width and the CNN paths' four clients: synthetic
    CIFAR-10 at 32x32, 8:1:1, Dirichlet beta = 1.0.  Returns the config,
    the clients' shards, the test set and the pooled train set."""
    from repro_torch.configs.cnn import vgg_for
    from repro_torch.data.partition import partition_dirichlet
    from repro_torch.data.synthetic import make_image_dataset, split_811

    ds = make_image_dataset("cifar10", 2400, 10, 32, 3, 0.55)
    splits = split_811(ds)
    parts = partition_dirichlet(splits["train"], 4, beta=1.0, seed=0)
    client_data = []
    for p in parts:
        s = split_811(p, seed=1)
        client_data.append({"train": s["train"], "val": s["val"],
                            "test": s["test"]})
    return (vgg_for("cifar10", tiny=False), client_data, splits["test"],
            splits["train"])


def phase_main_path(kern, dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.fl.backend import CNNBackend
    from repro_torch.models import cnn

    sig = kern["sig"]
    others = [kern[k] for k in ("fa", "ss", "ml", "sl")]
    cfg, client_data, test, _ = cnn_world()
    backend = CNNBackend(cfg, local_epochs=1, batch_size=64)
    check(backend.device.type == "cuda", "backend is not on the card")
    # warm-up outside the counted run: cuDNN plans, allocator pools
    warm = backend.init(torch.Generator().manual_seed(1))
    backend.evaluate(backend.train_local(warm, client_data[0]["train"],
                                         epochs=1)[0], client_data[0]["val"])
    del warm

    # Each backend call ends in a host copy (float(...) or .cpu()), so a
    # host clock around it covers its device work.
    calls = {"train_local": 0, "evaluate": 0, "signature": 0, "plain": 0}
    seconds = {"train_local": 0.0, "evaluate": 0.0, "signature": 0.0}
    signatures = []

    def counted(name, fn, keep=None):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            calls[name] += 1
            if name in seconds:
                seconds[name] += time.perf_counter() - t
            if keep is not None:
                keep.append(out)
            return out
        return wrapper

    inner_plain = sig.signature_counts_plain
    backend.train_local = counted("train_local", backend.train_local)
    backend.evaluate = counted("evaluate", backend.evaluate)
    backend.signature = counted("signature", backend.signature, signatures)
    sig.signature_counts_plain = counted("plain", inner_plain)
    coord = DagAflCoordinator(backend, client_data, test,
                              DagAflConfig(n_clients=4, max_rounds=2,
                                           local_epochs=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in [sig] + others:                     # counts start here
        mod.launches = 0
    sig.launches_vec = sig.launches_strided = 0
    t0 = time.perf_counter()
    result = coord.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sig.launches                        # and are read here
    routes = {"vec": sig.launches_vec, "strided": sig.launches_strided}
    other_launches = [mod.launches for mod in others]
    sig.signature_counts_plain = inner_plain
    seconds["rest"] = wall - sum(seconds.values())
    peak = torch.cuda.max_memory_allocated()

    rounds = result.rounds
    accs = [result.final_accuracy, result.best_accuracy,
            result.extra["tip_mean_accuracy"],
            result.extra["client_mean_accuracy"]]
    accs += [a for _, a in result.history]
    gm = coord.global_model()
    ok, why = verify_full_dag(coord.ledger)
    check(rounds == 8, f"expected 8 rounds (4 clients x 2), got {rounds}")
    check(result.extra["chain_len"] == 1 + rounds,
          f"chain_len {result.extra['chain_len']} != 1 + {rounds}")
    check(result.extra["verify_failures"] == 0, "path verification failed")
    check(ok, f"verify_full_dag: {why}")
    check(launches == calls["signature"] == rounds,
          f"signature kernel launched {launches} times for "
          f"{calls['signature']} signature calls over {rounds} rounds")
    check(calls["plain"] == 0, "the main path ran the plain signature")
    check(routes == {"vec": launches, "strided": 0},
          f"signature launches by route {routes}: every one of the "
          f"{launches} must take the vec kernel")
    check(not any(other_launches), f"the CNN path launched flash, scan or "
          f"xLSTM kernels {other_launches}")
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
          f"accuracies {accs}")
    check(all(p.is_cuda for p in tree_leaves(gm)), "model left the card")
    check(all(s.shape == (64,) and np.all((s >= 0) & (s <= 1))
              for s in signatures), "signatures are not 64 fractions")
    ref = reference_check(cnn, cfg, dev, gm)
    emit(phase="main_path", model=cfg.name, image=[32, 32, 3],
         n_params=sum(p.numel() for p in tree_leaves(gm)),
         clients=4, rounds=rounds, chain_len=result.extra["chain_len"],
         wall_s=wall, s_per_round=wall / rounds, peak_bytes=peak,
         final_accuracy=result.final_accuracy,
         tip_mean_accuracy=result.extra["tip_mean_accuracy"],
         client_mean_accuracy=result.extra["client_mean_accuracy"],
         calls=calls, seconds=seconds, signature_launches=launches,
         signature_routes=routes, verify_full_dag=why, **ref)
    return {"signature": launches, "signature_routes": routes,
            "s_per_round": wall / rounds, "sim_time": result.sim_time}


def cohort_parity(backend, window) -> dict:
    """One window of the counted run done again by the sequential calls on
    the card: its aggregates and seeds through ``train_local`` (trained
    leaves within the reference's 5e-3 of the window's), and its trained
    models through ``evaluate`` (the same correct counts) and ``signature``
    (within 1/1024 per channel)."""
    import numpy as np
    from repro_torch.core.aggregate import tree_leaves, tree_map

    agg, datasets, seeds, epochs = window["train_in"]
    trained = window["trained"]
    train_err = 0.0
    for k, (ds, seed) in enumerate(zip(datasets, seeds)):
        solo, _ = backend.train_local(tree_map(lambda l: l[k], agg), ds,
                                      seed=seed, epochs=epochs)
        train_err = max(train_err, max(
            (a - b[k]).abs().max().item()
            for a, b in zip(tree_leaves(solo), tree_leaves(trained))))
    check(train_err <= 5e-3, f"cohort_path: trained leaves differ from "
          f"train_local's by {train_err} (> 5e-3)")
    val_sets, accs = window["evaluated"]
    counts = []
    for k, (ds, acc) in enumerate(zip(val_sets, accs)):
        n = min(len(ds), 512)
        want = backend.evaluate(tree_map(lambda l: l[k], trained), ds)
        counts.append([round(acc * n), round(want * n), n])
        check(counts[-1][0] == counts[-1][1], f"cohort_path: client {k} "
              f"correct counts {counts[-1]} differ from evaluate's")
    sig_sets, sigs = window["signed"]
    sig_err, channels = 0.0, 0
    for k, (ds, got) in enumerate(zip(sig_sets, sigs)):
        want = backend.signature(tree_map(lambda l: l[k], trained), ds)
        sig_err = max(sig_err, float(np.abs(got - want).max()))
        channels += int(np.sum(got != want))
    check(sig_err <= 1 / 1024, f"cohort_path: signatures differ from "
          f"signature's by {sig_err} (> 1/1024)")
    return {"clients": len(seeds), "train_max_abs_err": train_err,
            "correct_counts": counts, "signature_max_abs_err": sig_err,
            "signature_channels_differing": channels}


def im2col_losses(stacked, x, y):
    """The reference's form of the cohort's training forward
    (``_conv_as_matmul`` in its ``fl/cohort.py``): each client's
    convolutions as im2col and one batched product a layer, taps in
    (kh, kw, cin) order; x (K, B, H, W, C) -> (K,) mean losses.  Timed
    beside the engine's grouped convolutions."""
    import torch
    import torch.nn.functional as F
    k, b = x.shape[:2]
    for stack_params in stacked["convs"]:
        for p in stack_params:
            kh, kw, _, cout = p["w"].shape[1:]
            h, w = x.shape[2:4]
            xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
            patches = torch.stack([xp[:, :, i:i + h, j:j + w]
                                   for i in range(kh) for j in range(kw)],
                                  dim=4)
            y_conv = torch.bmm(patches.reshape(k, b * h * w, -1),
                               p["w"].reshape(k, -1, cout))
            x = torch.relu(y_conv.reshape(k, b, h, w, cout)
                           + p["b"][:, None, None, None])
        x = F.max_pool2d(x.flatten(0, 1).permute(0, 3, 1, 2), 2)
        x = x.permute(0, 2, 3, 1).unflatten(0, (k, b))
    x = x.reshape(k, b, -1)
    for p in stacked["fcs"][:-1]:
        x = torch.relu(torch.baddbmm(p["b"][:, None], x, p["w"]))
    p = stacked["fcs"][-1]
    logits = torch.baddbmm(p["b"][:, None], x, p["w"])
    ll = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - ll).mean(-1)


def train_step_forms(engine, cfg, stacked, x, y, reps: int = 5) -> dict:
    """One training step (forward and backward of the summed losses) of K
    stacked clients on batches x (K, B, ...), timed with CUDA events in
    three forms, in turns: the engine's grouped convolutions, the
    reference's im2col products, and K sequential steps of
    ``cnn_loss``; and each form's gradients against the engine's."""
    import torch
    from repro_torch.core.aggregate import tree_leaves, tree_map
    from repro_torch.models import cnn

    def sequential(st, x, y):
        return torch.stack([cnn.cnn_loss(
            tree_map(lambda l: l[k], st), {"images": x[k], "labels": y[k]},
            cfg)[0] for k in range(x.shape[0])])

    def grouped(st, x, y):
        rows = torch.ones(x.shape[1], device=x.device)
        return engine.programs.sum_loss(st, x, y, rows, rows.sum())

    forms = {"grouped": grouped, "im2col": im2col_losses,
             "sequential": sequential}
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      stacked)
    leaves = tree_leaves(params)

    def step(fn):
        for t in leaves:
            t.grad = None
        fn(params, x, y).sum().backward()

    grads = {}
    for name, fn in forms.items():
        step(fn)
        step(fn)
        grads[name] = [t.grad.clone() for t in leaves]
    times = {name: [] for name in forms}
    for name in ("grouped", "im2col", "sequential", "sequential", "im2col",
                 "grouped"):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            step(forms[name])
        end.record()
        end.synchronize()
        times[name].append(start.elapsed_time(end) / reps)
    return {"clients": x.shape[0], "batch": x.shape[1],
            "ms": {name: sum(t) / len(t) for name, t in times.items()},
            "grad_max_abs_diff": {
                name: max((a - b).abs().max().item()
                          for a, b in zip(grads[name], grads["grouped"]))
                for name in ("im2col", "sequential")}}


def phase_cohort_path(kern, dev, main_s_per_round: float) -> dict:
    """The CNN path's world and loop on the cohort engine
    (``cohort_size=4``, ``cohort_window=2.0``), timed by call; then one
    window held against the sequential calls (``cohort_parity``)."""
    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves, tree_stack
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.fl.backend import CNNBackend
    from repro_torch.fl.cohort import CohortBackend

    sig = kern["sig"]
    others = [kern[k] for k in ("fa", "ss", "ml", "sl")]
    cfg, client_data, test, _ = cnn_world()
    backend = CNNBackend(cfg, local_epochs=1, batch_size=64)
    check(backend.device.type == "cuda", "cohort_path: backend is not on "
          "the card")
    engine = CohortBackend(backend)
    # warm-up windows outside the counted run, one of each size a window
    # can take (each size has its own grouped convolutions): cuDNN's
    # kernels, allocator pools, the engine's cached validation sets
    trains = [cd["train"] for cd in client_data]
    vals = [cd["val"] for cd in client_data]
    # one genesis draw as the run makes it, timed: host work in "rest"
    t0 = time.perf_counter()
    warm = [backend.init(torch.Generator().manual_seed(0))]
    torch.cuda.synchronize()
    genesis_s = time.perf_counter() - t0
    warm += [backend.init(torch.Generator().manual_seed(s))
             for s in range(1, 4)]
    for k in (2, 3, 4):
        trained, _ = engine.train_cohort(warm[:k], trains[:k],
                                         list(range(k)), epochs=1)
    warm = trained
    engine.evaluate_cohort(warm, vals)
    engine.signature_cohort(warm, trains)
    engine.evaluate_shared(warm[0], vals)
    engine.evaluate_many(warm, test)
    del warm

    # Each call ends in a host copy, so a host clock around it covers its
    # device work; a call made inside another (evaluate_many's M = 1 path
    # calls evaluate) is counted but not timed twice.
    engine_calls = ("train_cohort_stacked", "evaluate_cohort_stacked",
                    "signature_cohort_stacked", "evaluate_many",
                    "evaluate_shared")
    backend_calls = ("train_local", "evaluate", "signature")
    calls = {name: 0 for name in engine_calls + backend_calls + ("plain",)}
    seconds = {name: 0.0 for name in engine_calls + backend_calls}
    depth, last_s = [0], {}
    window, signatures, accs, windows, steps = {}, [], [], [], []

    def counted(name, fn, keep=None):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            calls[name] += 1
            last_s[name] = time.perf_counter() - t
            if name in seconds and depth[0] == 0:
                seconds[name] += last_s[name]
            if keep is not None:
                keep(args, out)
            return out
        return wrapper

    def keep_train(args, out):
        # each client's real steps; the window pads them to its longest
        steps.append({"steps": [max(len(ds) // backend.batch_size, 1)
                                for ds in args[1]],
                      "seconds": last_s["train_cohort_stacked"]})
        window.setdefault("train_in", args[:3] + (1,))
        window.setdefault("trained", out[0])

    def keep_engine(key, found):
        def keep(args, out):
            found.extend(out)
            window.setdefault(key, (args[1], out))
        return keep

    inner_plain = sig.signature_counts_plain
    engine.train_cohort_stacked = counted(
        "train_cohort_stacked", engine.train_cohort_stacked, keep_train)
    engine.evaluate_cohort_stacked = counted(
        "evaluate_cohort_stacked", engine.evaluate_cohort_stacked,
        keep_engine("evaluated", accs))
    engine.signature_cohort_stacked = counted(
        "signature_cohort_stacked", engine.signature_cohort_stacked,
        keep_engine("signed", signatures))
    engine.evaluate_many = counted("evaluate_many", engine.evaluate_many,
                                   lambda a, out: accs.extend(out))
    engine.evaluate_shared = counted("evaluate_shared",
                                     engine.evaluate_shared,
                                     lambda a, out: accs.extend(out))
    backend.train_local = counted("train_local", backend.train_local)
    backend.evaluate = counted("evaluate", backend.evaluate,
                               lambda a, out: accs.append(out))
    backend.signature = counted("signature", backend.signature,
                                lambda a, out: signatures.append(out))
    sig.signature_counts_plain = counted("plain", inner_plain)
    coord = DagAflCoordinator(
        backend, client_data, test,
        DagAflConfig(n_clients=4, max_rounds=2, local_epochs=1,
                     cohort_size=4, cohort_window=2.0),
        cohort_engine=engine)
    check(coord.cohort is engine, "cohort_path: the coordinator took no "
          "cohort engine")
    flush = coord._window.flush_fn

    def counted_flush(batch):
        windows.append(len(batch))
        flush(batch)

    coord._window.flush_fn = counted_flush
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in [sig] + others:                     # counts start here
        mod.launches = 0
    sig.launches_vec = sig.launches_strided = 0
    t0 = time.perf_counter()
    result = coord.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sig.launches                        # and are read here
    routes = {"vec": sig.launches_vec, "strided": sig.launches_strided}
    other_launches = [mod.launches for mod in others]
    sig.signature_counts_plain = inner_plain
    seconds["rest"] = wall - sum(seconds.values())
    # the parity check below calls the wrapped methods again
    run_calls, run_seconds = dict(calls), dict(seconds)
    peak = torch.cuda.max_memory_allocated()

    rounds = result.rounds
    batched = sum(n for n in windows if n > 1)
    accs += [result.final_accuracy, result.best_accuracy,
             result.extra["tip_mean_accuracy"],
             result.extra["client_mean_accuracy"]]
    accs += [a for _, a in result.history]
    ok, why = verify_full_dag(coord.ledger)
    models = [coord.store.get(tx.model_ref)
              for tx in coord.ledger.transactions()]
    check(rounds == 8, f"cohort_path: expected 8 rounds, got {rounds}")
    check(result.extra["chain_len"] == 1 + rounds,
          f"cohort_path: chain_len {result.extra['chain_len']} != 1 + "
          f"{rounds}")
    check(result.extra["verify_failures"] == 0,
          "cohort_path: path verification failed")
    check(ok, f"cohort_path: verify_full_dag: {why}")
    check(result.extra["cohorts_dispatched"] >= 1 and "train_in" in window,
          f"cohort_path: {result.extra['cohorts_dispatched']} windows "
          f"dispatched to the engine (window sizes {windows})")
    # one launch per round: a client of a window, or a window of one
    check(launches == rounds == batched + run_calls["signature"],
          f"cohort_path: signature kernel launched {launches} times for "
          f"{rounds} rounds ({batched} in windows, {run_calls['signature']} "
          f"alone)")
    check(routes == {"vec": launches, "strided": 0},
          f"cohort_path: signature launches by route {routes}: every one "
          f"of the {launches} must take the vec kernel")
    check(run_calls["plain"] == 0, "cohort_path: ran the plain signature")
    check(not any(other_launches), f"cohort_path: launched flash, scan or "
          f"xLSTM kernels {other_launches}")
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
          f"cohort_path: accuracies {accs}")
    check(all(p.is_cuda for m in models for p in tree_leaves(m)),
          "cohort_path: a model left the card")
    check(len(signatures) == rounds
          and all(np.shape(s) == (64,) and np.all((s >= 0) & (s <= 1))
                  for s in signatures),
          "cohort_path: signatures are not 64 fractions")
    parity = cohort_parity(backend, window)
    # the training step's forms, at the window's full width of 4 clients
    batch = engine.assembler.take(trains, [1, 2, 3, 4], 1)
    forms = train_step_forms(
        engine, cfg, tree_stack([backend.init(torch.Generator().manual_seed(s))
                                 for s in range(4)]),
        batch.xb[:, 0], batch.yb[:, 0])
    emit(phase="cohort_path", model=cfg.name, image=[32, 32, 3],
         n_params=sum(p.numel() for p in tree_leaves(models[0])),
         clients=4, cohort_size=4, cohort_window=2.0, rounds=rounds,
         chain_len=result.extra["chain_len"],
         cohorts_dispatched=result.extra["cohorts_dispatched"],
         windows=windows, rounds_in_windows=batched, window_steps=steps,
         wall_s=wall, genesis_s=genesis_s,
         s_per_round=wall / rounds, peak_bytes=peak,
         main_path_s_per_round=main_s_per_round,
         ratio_to_main_path=wall / rounds / main_s_per_round,
         final_accuracy=result.final_accuracy,
         tip_mean_accuracy=result.extra["tip_mean_accuracy"],
         client_mean_accuracy=result.extra["client_mean_accuracy"],
         calls=run_calls, seconds=run_seconds, signature_launches=launches,
         signature_routes=routes, verify_full_dag=why, parity=parity,
         train_step=forms)
    return {"signature": launches, "signature_routes": routes}


# the calls the FL phases time: the backend's and the cohort engine's
BACKEND_CALLS = ("train_local", "evaluate", "signature")
ENGINE_CALLS = ("train_cohort_stacked", "evaluate_cohort_stacked",
                "signature_cohort_stacked", "evaluate_many",
                "evaluate_shared", "perturb_cohort_stacked")
# the baselines' (rounds, local trainings) at 4 clients and max_rounds 2:
# fedat and csafl count tier arrivals (3 tiers x 2 rounds); fedasync counts
# arrivals, and the 3 rounds in flight when the 8th arrives still arrive;
# the DAG runs count publishes; centralized trains on the pooled set
BASELINE_ROUNDS = {"centralized": (2, 2), "independent": (2, 8),
                   "fedavg": (2, 8), "fedasync": (11, 11), "fedat": (6, 8),
                   "csafl": (6, 8), "fedhisyn": (2, 8), "scalesfl": (2, 8),
                   "dagfl": (8, 8), "dagafl": (8, 8)}
COHORT_BASELINES = ("fedavg", "fedasync", "fedat", "csafl", "dagfl",
                    "dagafl")
SCENARIO_ORDER = ("poison", "lazy", "dp", "straggler", "dropout")
# each scenario's primary event counter (benchmarks/robustness.py's
# EVENT_KEYS): the phase requires it nonzero
EVENT_KEYS = {"poison": "updates_scaled", "lazy": "updates_lazy",
              "dp": "updates_noised", "straggler": "straggler_draws",
              "dropout": "publishes_dropped"}


class CallMeter:
    """Counts and host seconds of the backend's and the cohort engine's
    calls over one run, the client rounds trained (``train_local`` calls
    and the rows of ``train_cohort_stacked``), the signatures taken (the
    same for ``signature`` and ``signature_cohort_stacked``), the windows
    given to the engine, the coordinators the run built, and whether every
    model evaluated lay on the card.  Each call ends in a host copy, so a
    host clock around it covers its device work; the transform returns
    tensors, so the meter synchronizes after it.  A call made inside
    another is counted, not timed twice."""

    def __init__(self, backend, sig):
        import torch
        from repro_torch.core.aggregate import tree_leaves
        from repro_torch.core.coordinator import DagAflCoordinator
        from repro_torch.fl.cohort import CohortBackend

        self.saved, self.depth = [], 0
        self.reset()

        def on_card(*trees):
            self.models_checked += 1
            if not all(t.is_cuda for tree in trees
                       for t in tree_leaves(tree)):
                self.off_card += 1

        def rows_trained(args, out):
            self.client_rounds += len(args[2])
            self.windows.append(len(args[2]))

        hooks = {
            "train_local": lambda a, o: setattr(
                self, "client_rounds", self.client_rounds + 1),
            "evaluate": lambda a, o: on_card(a[0]),
            "signature": lambda a, o: setattr(
                self, "signature_calls", self.signature_calls + 1),
            "train_cohort_stacked": rows_trained,
            "evaluate_shared": lambda a, o: on_card(a[1]),
            "signature_cohort_stacked": lambda a, o: setattr(
                self, "signature_calls", self.signature_calls + len(a[2])),
            "perturb_cohort_stacked": lambda a, o: torch.cuda.synchronize(),
        }
        for name in BACKEND_CALLS:
            self._wrap(backend, name, hooks.get(name))
        for name in ENGINE_CALLS:
            self._wrap(CohortBackend, name, hooks.get(name))
        self._wrap(sig, "signature_counts_plain", None, "plain")
        self._wrap(DagAflCoordinator, "run",
                   lambda a, o: self.coords.append(a[0]), "coordinator_run")

    def reset(self) -> None:
        self.calls = {n: 0 for n in BACKEND_CALLS + ENGINE_CALLS
                      + ("plain", "coordinator_run")}
        self.seconds = {n: 0.0 for n in BACKEND_CALLS + ENGINE_CALLS}
        self.client_rounds = self.signature_calls = 0
        self.models_checked = self.off_card = 0
        self.windows, self.coords = [], []

    def _wrap(self, owner, name, hook, key=None) -> None:
        inner = getattr(owner, name)
        key = key or name

        timed = key in self.seconds

        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            self.depth += timed
            try:
                out = inner(*args, **kwargs)
            finally:
                self.depth -= timed
            if hook is not None:
                hook(args, out)
            self.calls[key] += 1
            if timed and self.depth == 0:
                self.seconds[key] += time.perf_counter() - t
            return out

        self.saved.append((owner, name, inner))
        setattr(owner, name, wrapper)

    def close(self) -> None:
        for owner, name, inner in reversed(self.saved):
            setattr(owner, name, inner)


def fl_run(meter, kern, label, fn, *args, **kwargs) -> tuple:
    """One run of ``fn`` (a baseline or the coordinator), with every
    kernel's launch count and the meter set to 0 just before it and read
    just after: (result, record).  Earlier runs' garbage (the coordinators'
    stores reference themselves) is collected first; ``live_bytes`` is
    what stays allocated then (the genesis, a kept reference run), and
    ``peak_bytes`` that plus this run's own peak."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves

    sig = kern["sig"]
    others = [kern[k] for k in ("fa", "ss", "ml", "sl")]
    meter.reset()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    for mod in [sig] + others:                     # counts start here
        mod.launches = 0
    sig.launches_vec = sig.launches_strided = 0
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sig.launches                        # and are read here
    routes = {"vec": sig.launches_vec, "strided": sig.launches_strided}
    other_launches = [mod.launches for mod in others]
    seconds = dict(meter.seconds)
    seconds["rest"] = wall - sum(seconds.values())
    accs = [result.final_accuracy, result.best_accuracy]
    accs += [a for _, a in result.history]
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
          f"{label}: accuracies {accs}")
    check(meter.models_checked > 0 and meter.off_card == 0,
          f"{label}: {meter.off_card} of {meter.models_checked} models "
          f"evaluated off the card")
    check(meter.calls["plain"] == 0, f"{label}: ran the plain signature")
    check(not any(other_launches), f"{label}: launched flash, scan or "
          f"xLSTM kernels {other_launches}")
    record = {"run": label, "rounds": result.rounds,
              "client_rounds": meter.client_rounds, "wall_s": wall,
              "s_per_client_round": wall / max(meter.client_rounds, 1),
              "sim_time": result.sim_time,
              "final_accuracy": result.final_accuracy,
              "best_accuracy": result.best_accuracy,
              "live_bytes": live,
              "peak_bytes": torch.cuda.max_memory_allocated(),
              "calls": dict(meter.calls), "seconds": seconds,
              "windows": list(meter.windows),
              "cohorts_dispatched": result.extra.get(
                  "cohorts_dispatched", sum(n > 1 for n in meter.windows)),
              "signature_launches": launches, "signature_routes": routes}
    if meter.coords:
        coord = meter.coords[-1]
        check(len(meter.coords) == 1, f"{label}: {len(meter.coords)} "
              f"coordinator runs")
        check(all(p.is_cuda for tx in coord.ledger.transactions()
                  for p in tree_leaves(coord.store.get(tx.model_ref))),
              f"{label}: a model left the card")
        # one launch per signature: a client of a window, or a round alone
        check(launches == meter.signature_calls,
              f"{label}: signature kernel launched {launches} times for "
              f"{meter.signature_calls} signatures")
        check(routes == {"vec": launches, "strided": 0},
              f"{label}: signature launches by route {routes}: every one "
              f"of the {launches} must take the vec kernel")
        record["chain_len"] = result.extra["chain_len"]
    else:
        check(launches == 0, f"{label}: {launches} signature launches "
              f"outside a DAG run")
    return result, record


def dag_checks(label, coord, result, tampered=()) -> str:
    """The DAG runs' ledger checks: chain_len == 1 + rounds; without
    tampering no failed path audit and ``verify_full_dag`` ok, with it
    ``verify_full_dag`` failing."""
    from repro_torch.core.verify import verify_full_dag
    ok, why = verify_full_dag(coord.ledger)
    check(result.extra["chain_len"] == 1 + result.rounds,
          f"{label}: chain_len {result.extra['chain_len']} != 1 + "
          f"{result.rounds}")
    if tampered:
        check(not ok, f"{label}: verify_full_dag passed a ledger with "
              f"{len(tampered)} tampered txs")
    else:
        check(result.extra["verify_failures"] == 0,
              f"{label}: path verification failed")
        check(ok, f"{label}: verify_full_dag: {why}")
    return why


def phase_baselines_path(kern, dev) -> dict:
    """The paper's competitors at full VGG16 width: all ten ``ALGORITHMS``
    (4 clients, 2 rounds, convergence by patience off, one genesis drawn
    once and given to every run), then the six the reference batches again
    on the cohort engine (``cohort_size=4``, ``cohort_window=2.0``)."""
    import torch
    from repro_torch.core.simulator import CostModel
    from repro_torch.fl import ALGORITHMS, FLConfig
    from repro_torch.fl.backend import CNNBackend

    t_phase = time.perf_counter()
    sig = kern["sig"]
    cfg, client_data, test, pooled = cnn_world()
    backend = CNNBackend(cfg, local_epochs=1, batch_size=64)
    check(backend.device.type == "cuda", "baselines_path: backend is not "
          "on the card")
    genesis = backend.init(torch.Generator().manual_seed(0))
    meter = CallMeter(backend, sig)
    records, launches, vec, strided = [], 0, 0, 0
    try:
        for cohort in (1, 4):
            names = sorted(ALGORITHMS) if cohort == 1 else COHORT_BASELINES
            for name in names:
                label = f"{name}" + ("" if cohort == 1 else "@cohort4")
                fl = FLConfig(n_clients=4, max_rounds=2, local_epochs=1,
                              target_accuracy=None, patience=10 ** 6,
                              cohort_size=cohort, cohort_window=2.0)
                kw = ({"pooled_train": pooled} if name == "centralized"
                      else {})
                result, record = fl_run(
                    meter, kern, label, ALGORITHMS[name], backend,
                    client_data, test, fl, CostModel(), None,
                    init_model=genesis, **kw)
                rounds, trainings = BASELINE_ROUNDS[name]
                check(result.rounds == rounds, f"{label}: {result.rounds} "
                      f"rounds, expected {rounds}")
                check(record["client_rounds"] == trainings,
                      f"{label}: {record['client_rounds']} local trainings, "
                      f"expected {trainings}")
                if cohort > 1:
                    check(record["cohorts_dispatched"] >= 1,
                          f"{label}: no window dispatched to the engine "
                          f"(windows {record['windows']})")
                if meter.coords:
                    record["verify_full_dag"] = dag_checks(
                        label, meter.coords[-1], result)
                launches += record["signature_launches"]
                vec += record["signature_routes"]["vec"]
                strided += record["signature_routes"]["strided"]
                records.append(record)
    finally:
        meter.close()
    check(launches > 0, "baselines_path: the DAG runs launched no signature")
    emit(phase="baselines_path", model=cfg.name, image=[32, 32, 3],
         clients=4, max_rounds=2, phase_s=time.perf_counter() - t_phase,
         runs=records)
    return {"signature": launches,
            "signature_routes": {"vec": vec, "strided": strided}}


def honest_client_mean(backend, coord, test, exclude) -> float:
    """Mean global-test accuracy of the latest published models of the
    clients outside ``exclude`` (``benchmarks/robustness.py``'s
    ``_honest_client_mean``): what an honest participant ends up with."""
    import numpy as np
    models = []
    for c in range(coord.cfg.n_clients):
        tx = coord.ledger.latest_of(c)
        if c in exclude or tx is None or not coord.ledger.has_tx(tx):
            continue
        ref = coord.ledger.get_tx(tx).model_ref
        if ref in coord.store:
            models.append(coord.store.get(ref))
    if not models:
        return 0.0
    if coord.cohort is not None:
        accs = coord.cohort.evaluate_many(models, test)
    else:
        accs = [backend.evaluate(m, test) for m in models]
    return float(np.mean(accs))


def transform_check(genesis, trained, sigma: float) -> dict:
    """The scenario transform on VGG16's own leaves on the card: a window
    of 4 (poisoned, free-rider, noised, unaffected) against the four
    single calls bit for bit, the unaffected row's bits kept, and the DP
    noise's mean and standard deviation over one model's draws."""
    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves, tree_map, tree_stack
    from repro_torch.fl.cohort import (perturb_cohort_stacked_trees,
                                       perturb_update)

    k = len(trained)
    plan = {"seed": 0, "clients": np.arange(k, dtype=np.int64),
            "seqs": np.arange(k, dtype=np.int64) + 2,
            "gammas": np.array([-4.0, 0.0, 1.0, 1.0], np.float32),
            "sigmas": np.array([0.0, 0.0, sigma, 0.0], np.float32),
            "affected": np.array([True, True, True, False])}
    aggs, news = tree_stack([genesis] * k), tree_stack(trained)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window = perturb_cohort_stacked_trees(aggs, news, plan)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    differing = 0
    for r in range(3):
        single = perturb_update(genesis, trained[r], plan, r)
        differing += sum(int((a != b[r]).sum()) for a, b in zip(
            tree_leaves(single), tree_leaves(window)))
    kept = all(torch.equal(a, b[3]) for a, b in zip(
        tree_leaves(trained[3]), tree_leaves(window)))
    check(differing == 0, f"scenarios_path: the window's rows differ from "
          f"the single calls in {differing} elements")
    check(kept, "scenarios_path: the unaffected row lost its bits")
    check(all(t.is_cuda for t in tree_leaves(window)),
          "scenarios_path: the transform left the card")
    zeros = tree_map(torch.zeros_like, genesis)
    noise = perturb_update(zeros, zeros, {
        "seed": 0, "clients": np.array([1]), "seqs": np.array([0]),
        "gammas": np.array([1.0], np.float32),
        "sigmas": np.array([sigma], np.float32),
        "affected": np.array([True])}, 0)
    draws = torch.cat([t.flatten().double() for t in tree_leaves(noise)])
    mean, std = draws.mean().item(), draws.std().item()
    check(abs(mean) <= 0.01 * sigma and abs(std - sigma) <= 0.01 * sigma,
          f"scenarios_path: DP noise mean {mean}, std {std} for sigma "
          f"{sigma} over {draws.numel()} draws")
    return {"window_clients": k, "window_s": window_s,
            "stacked_vs_single_differing": differing,
            "unaffected_row_kept": kept, "noise_draws": draws.numel(),
            "noise_mean": mean, "noise_std": std, "sigma": sigma}


def phase_scenarios_path(kern, dev) -> dict:
    """The fault-injection scenarios at full VGG16 width on the cohort
    engine (``cohort_size=4``, ``cohort_window=2.0``, 3 rounds): an honest
    DAG-AFL run, DAG-AFL under each scenario, and poison on fedavg and
    fedasync beside their honest runs; each scenario's event counter, the
    Eq. 7 audit of every ledger, the quarantine metrics and the accuracy
    change; then the transform itself on VGG16's leaves."""
    import dataclasses

    import torch
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.simulator import CostModel
    from repro_torch.core.verify import IncrementalVerifier, detect_tampered
    from repro_torch.fl import (ALGORITHMS, SCENARIOS, FLConfig, Scenario,
                                dag_attack_metrics)
    from repro_torch.fl.backend import CNNBackend

    t_phase = time.perf_counter()
    sig = kern["sig"]
    cfg, client_data, test, _ = cnn_world()
    backend = CNNBackend(cfg, local_epochs=1, batch_size=64)
    check(backend.device.type == "cuda", "scenarios_path: backend is not "
          "on the card")
    genesis = backend.init(torch.Generator().manual_seed(0))
    geo = dict(n_clients=4, max_rounds=3, local_epochs=1,
               target_accuracy=None, patience=10 ** 6, cohort_size=4,
               cohort_window=2.0)
    meter = CallMeter(backend, sig)
    records, launches, vec, strided = [], 0, 0, 0

    def dagafl(label, scenario):
        coord = DagAflCoordinator(backend, client_data, test,
                                  DagAflConfig(scenario=scenario, **geo),
                                  CostModel())
        result, record = fl_run(meter, kern, label, coord.run, genesis)
        tampered = [] if scenario is None else scenario.tampered
        record["verify_full_dag"] = dag_checks(label, coord, result,
                                               tampered)
        check(record["cohorts_dispatched"] >= 1,
              f"{label}: no window dispatched to the engine")
        detected = detect_tampered(coord.ledger)
        audit_ok, _ = IncrementalVerifier(coord.ledger).audit()
        check(sorted(detected) == sorted(tampered),
              f"{label}: detected {len(detected)} tampered txs, "
              f"{len(tampered)} were tampered")
        check(audit_ok == (not tampered), f"{label}: the incremental audit "
              f"{'passed' if audit_ok else 'flagged'} with {len(tampered)} "
              f"tampered txs")
        record.update(tamper_detections=len(detected),
                      txs_tampered=len(tampered),
                      incremental_audit_flagged=not audit_ok)
        return coord, result, record

    def baseline(label, name, scenario):
        return fl_run(meter, kern, label, ALGORITHMS[name], backend,
                      client_data, test, FLConfig(scenario=scenario, **geo),
                      CostModel(), None, init_model=genesis)

    try:
        honest_coord, _, record = dagafl("dagafl:honest", None)
        records.append(record)
        honest = {name: baseline(f"{name}:honest", name, None)
                  for name in ("fedavg", "fedasync")}
        records += [rec for _, rec in honest.values()]
        for name in SCENARIO_ORDER:
            sc = Scenario(dataclasses.replace(SCENARIOS[name], seed=0), 4)
            coord, result, record = dagafl(f"dagafl:{name}", sc)
            counts = sc.counts()
            check(counts[EVENT_KEYS[name]] > 0, f"dagafl:{name}: "
                  f"{EVENT_KEYS[name]} is 0 ({counts})")
            check(result.extra["scenario_counts"] == counts,
                  f"dagafl:{name}: the result's counts differ from the "
                  f"injector's")
            honest_acc = honest_client_mean(backend, honest_coord, test,
                                            sc.malicious)
            attacked_acc = honest_client_mean(backend, coord, test,
                                              sc.malicious)
            record.update(scenario=name, counts=counts,
                          dag=dag_attack_metrics(coord.ledger, sc),
                          honest_accuracy=honest_acc,
                          attacked_accuracy=attacked_acc,
                          accuracy_delta=honest_acc - attacked_acc)
            records.append(record)
            del coord, result          # not live in the next run's peak
            if name != "poison":
                continue
            for algo in ("fedavg", "fedasync"):
                sc_b = Scenario(dataclasses.replace(SCENARIOS[name], seed=0),
                                4)
                result, record = baseline(f"{algo}:poison", algo, sc_b)
                check(sc_b.counts()["updates_scaled"] > 0,
                      f"{algo}:poison: no update was scaled")
                check(record["cohorts_dispatched"] >= 1,
                      f"{algo}:poison: no window dispatched to the engine")
                honest_acc = honest[algo][0].final_accuracy
                record.update(scenario=name, counts=sc_b.counts(),
                              honest_accuracy=honest_acc,
                              attacked_accuracy=result.final_accuracy,
                              accuracy_delta=(honest_acc
                                              - result.final_accuracy))
                records.append(record)
    finally:
        meter.close()
    for record in records:
        launches += record["signature_launches"]
        vec += record["signature_routes"]["vec"]
        strided += record["signature_routes"]["strided"]
    trained = [honest_coord.store.get(honest_coord.ledger.get_tx(
        honest_coord.ledger.latest_of(c)).model_ref) for c in range(4)]
    transform = transform_check(genesis, trained, SCENARIOS["dp"].dp_sigma)
    emit(phase="scenarios_path", model=cfg.name, image=[32, 32, 3],
         clients=4, max_rounds=3, cohort_size=4, cohort_window=2.0,
         phase_s=time.perf_counter() - t_phase, runs=records,
         transform=transform)
    return {"signature": launches,
            "signature_routes": {"vec": vec, "strided": strided}}


def lm_reference_check(tfm, cfg, backend, params, stream,
                       checked=True) -> dict:
    """The final global model's kernel forward (flash attention, the
    selective scan, the mLSTM and sLSTM kernels, as the model's layers
    have them) against its plain forward (dense attention, the models'
    own scans), both on the card in ``cfg``'s compute type, on one batch
    of the global test stream; held within LM_LOGIT_RTOL and LM_SIG_TOL
    when ``checked``."""
    import numpy as np
    import torch
    from repro_torch.runtime import Runtime
    batch = backend._batch(backend._sample(stream, np.random.default_rng(3),
                                           1)[0])
    with torch.inference_mode():
        k_logits, k_aux = tfm.forward(params, batch, cfg, Runtime(
            use_kernels=True, want_signature=True))
        p_logits, p_aux = tfm.forward(params, batch, cfg, Runtime(
            want_signature=True))
        logit_err = (k_logits - p_logits).abs().max().item()
        logit_mean_err = (k_logits - p_logits).abs().mean().item()
        scale = p_logits.abs().max().item()
        argmax_agree = (k_logits.argmax(-1) == p_logits.argmax(-1)
                        ).float().mean().item()
        sig_diff = (k_aux["signature"] - p_aux["signature"]).abs()
    n_rows = batch["tokens"].numel()
    flags_per_bucket = n_rows * cfg.d_model // 64
    check(bool(torch.isfinite(k_logits).all()), "non-finite LM logits")
    if checked:
        check(logit_err <= LM_LOGIT_RTOL * scale,
              f"kernel logits differ from the plain forward's by "
              f"{logit_err} (largest logit {scale}, {cfg.compute_dtype})")
        check(sig_diff.max().item() <= LM_SIG_TOL,
              f"kernel signature differs from plain by "
              f"{sig_diff.max().item()} ({cfg.compute_dtype})")
    return {"compute_dtype": cfg.compute_dtype, "checked": checked,
            "logits_max_abs_err": logit_err,
            "logits_mean_abs_err": logit_mean_err, "logits_scale": scale,
            "argmax_agreement": argmax_agree,
            "signature_max_abs_err": sig_diff.max().item(),
            "signature_net_flag_diff": int(round(
                sig_diff.sum().item() * flags_per_bucket))}


def profiled(fn):
    """``fn()`` twice under torch.profiler (device activity only), the
    first call letting the profiler start up: (the second call's trace,
    its wall seconds).  ``fn`` ends by synchronising the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = {}

    def keep(prof):
        traced["events"] = list(prof.events())
        traced["averages"] = list(prof.key_averages())

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],   # device work only
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        fn()
        prof.step()
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
        prof.step()
    return traced, wall


def device_busy(traced):
    """(busy microseconds: the union of the device's kernel and copy
    intervals, the intervals, the device kernels by time as (name, ms,
    count)) of a ``profiled`` trace."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA

    def on_device(name, annotation=False):
        # the profiler marks each step on the device too; that span
        # covers the whole step and is no work of the card
        return not (annotation or name.startswith("ProfilerStep"))

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in traced.get("events", ())
                   if e.device_type == cuda and on_device(
                       e.name, getattr(e, "is_user_annotation", False)))
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:                 # union of intervals
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(((a.key, a.self_device_time_total / 1e3, a.count)
                  for a in traced.get("averages", ())
                  if a.device_type == cuda and on_device(a.key)),
                 key=lambda kv: -kv[1])
    return busy_us, spans, top


def profile_lm_round(backend, params, stream) -> dict:
    """One backend round as the backend's defaults set it (``train_local``
    with its 8 local steps, then ``evaluate`` and ``signature``) under
    torch.profiler, after one round that lets the profiler start up: the
    device's busy time (the union of its kernels' and copies' intervals)
    against the round's wall time, and the device kernels that took the
    most time.  The profiler's host-side cost lengthens the wall time, so
    the idle share is an upper bound; host ops are not traced, to keep
    that cost small."""
    import torch
    from repro_torch.fl.backend import LMBackend

    def one_round():
        trained, _ = LMBackend.train_local(backend, params, stream, seed=5)
        LMBackend.evaluate(backend, trained, stream)
        LMBackend.signature(backend, trained, stream)
        torch.cuda.synchronize()

    traced, wall = profiled(one_round)
    busy_us, spans, top = device_busy(traced)
    flash = [(ms, n) for key, ms, n in top if "flash_attention" in key]
    # the xLSTM kernels' device time (the mLSTM's three launches a call)
    xlstm = {name: [(ms, n) for key, ms, n in top if mark in key]
             for name, mark in (("mlstm", "mlstm_"), ("slstm", "slstm_"))}
    return {"profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": (1.0 - busy_us / 1e6 / wall
                                  if spans else None),
            "device_kernels": len(spans),
            "device_kernel_ms": sum(ms for _, ms, _ in top),
            "flash_device_ms": sum(ms for ms, _ in flash),
            "flash_device_launches": sum(n for _, n in flash),
            **{f"{name}_device_ms": sum(ms for ms, _ in found)
               for name, found in xlstm.items()},
            **{f"{name}_device_kernels": sum(n for _, n in found)
               for name, found in xlstm.items()},
            "top_device_ms": [[k[:90], ms, n] for k, ms, n in top[:12]]}


def tree_param_count(cfg) -> int:
    """Parameters of the port's tree for a config of attention blocks
    (GQA with or without QKV biases and cross-attention, or MLA), Mamba,
    mLSTM and sLSTM blocks, with dense or MoE feed-forward layers or none,
    and an encoder, counted leaf by leaf from its shapes
    (``ArchConfig.param_count()`` counts a Mamba layer's small leaves and
    most of an xLSTM layer's leaves otherwise, and leaves out the
    norms)."""
    from repro_torch.configs.base import LayerSpec
    d, total = cfg.d_model, cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    norm = d if cfg.norm == "rmsnorm" else 2 * d         # scale (and bias)
    total += norm                                        # final norm
    specs = list(cfg.layer_specs())
    if cfg.encoder is not None:                          # its final norm,
        total += norm                                    # and its layers
        specs += [LayerSpec(kind="attn", ffn="dense")] * cfg.encoder.n_layers
    for spec in specs:
        total += norm                                    # norm1
        if spec.cross_attn:                              # xnorm, xw{q,k,v,o}
            total += norm + 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
        if spec.ffn == "dense" and cfg.d_ff > 0:
            total += norm + 3 * d * cfg.d_ff             # norm2, ffn
        elif spec.ffn == "moe":
            mo = cfg.moe                                 # norm2, router,
            total += (norm + d * mo.n_experts            # experts, shared
                      + 3 * mo.n_experts * d * mo.d_expert
                      + 3 * d * mo.n_shared * mo.d_expert)
        if spec.kind == "mlstm":
            xc = cfg.xlstm
            d_in = xc.m_expand * d
            d_qk = int(xc.m_qk_dim_factor * d_in)
            total += (d * 2 * d_in + xc.s_conv * d_in + d_in  # up, conv
                      + 2 * d_in * d_qk + d_in * d_in         # wq, wk, wv
                      + d_in * 2 * cfg.n_heads + 2 * cfg.n_heads  # w_if, b
                      + d_in + d_in * d)                # head norm, down
        elif spec.kind == "slstm":
            d_up = int(4 * d / 3) // 2 * 2
            total += (cfg.xlstm.s_conv * d + d                # conv
                      + 2 * d * 4 * d + 4 * d                 # W, R, b
                      + d * 2 * d_up + d_up * d + d)    # up, down, norm
        elif spec.kind == "attn" and cfg.mla is not None:
            m, H = cfg.mla, cfg.n_heads
            q_head = m.qk_nope_dim + m.qk_rope_dim
            total += (d * m.q_lora_rank + m.q_lora_rank              # wq_a
                      + m.q_lora_rank * H * q_head                   # wq_b
                      if m.q_lora_rank else d * H * q_head)          # wq
            total += (d * (m.kv_lora_rank + m.qk_rope_dim)          # wkv_a
                      + m.kv_lora_rank                              # norm
                      + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                      + H * m.v_head_dim * d)                       # wo
        elif spec.kind == "attn":
            total += 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
            if cfg.qkv_bias:
                total += cfg.q_dim + 2 * cfg.kv_dim
        else:
            mc = cfg.mamba
            d_in = mc.expand * d
            rank = mc.dt_rank or -(-d // 16)
            total += (d * 2 * d_in + mc.d_conv * d_in + d_in     # in, conv
                      + d_in * (rank + 2 * mc.d_state)           # x_proj
                      + rank * d_in + d_in                       # dt
                      + d_in * mc.d_state + d_in                 # A_log, D
                      + d_in * d)                                # out_proj
    return total


def phase_lm_loop(kern, dev, *, phase, cfg, clients, local_steps,
                  expected_params, reference_compute=None) -> dict:
    """The sequential DAG-AFL loop over ``clients`` ``LMBackend`` clients
    (2 rounds of 2 local SGD steps, batch 8 x 512 positions), with every
    kernel's launch count set to 0 just before the run and read just
    after; then the kernel forward against the plain forward on the card,
    and one profiled backend round.  ``kern`` holds the kernel modules
    ``sig``, ``fa``, ``ss``, ``ml`` and ``sl``.  With
    ``reference_compute``, the kernel forward is held against the plain
    forward with the model's products in that type (the same float32
    weights), and the comparison in the config's own type is reported."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.data.synthetic import make_lm_dataset
    from repro_torch.fl.backend import LMBackend
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Runtime

    sig, fa, ss, ml, sl = (kern[k] for k in ("sig", "fa", "ss", "ml",
                                               "sl"))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # launch/train.py's streams, drawn from a sub-vocabulary: its
    # vocab x vocab transition matrix would take 68.5 GB at internlm2's
    # 92,544 tokens and 34.4 GB at jamba's 65,536
    streams = [make_lm_dataset(vocab=LM_DATA_VOCAB, n_tokens=50_000,
                               order=1.5 + 0.5 * c, seed=c)
               for c in range(clients)]
    client_data = [{"train": s, "val": s, "test": s} for s in streams]
    global_test = make_lm_dataset(vocab=LM_DATA_VOCAB, n_tokens=50_000,
                                  seed=999)
    data_s = time.perf_counter() - t0
    backend = LMBackend(cfg, lr=3e-3, local_steps=local_steps, batch_size=8,
                        seq_len=512)
    check(backend.device.type == "cuda", f"{phase}: backend is not on the "
          f"card")
    t0 = time.perf_counter()
    genesis = backend.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(genesis))
    check(n_params == tree_param_count(cfg) == expected_params,
          f"{phase}: {n_params} parameters, expected {expected_params}")
    # warm-up outside the counted run: cuBLAS handles, allocator pools
    warm, _ = backend.train_local(genesis, streams[0], epochs=1)
    backend.evaluate(warm, streams[0])
    backend.signature(warm, streams[0])
    del warm

    calls = {"train_local": 0, "evaluate": 0, "signature": 0,
             "plain_flash": 0, "plain_signature": 0, "plain_scan": 0,
             "plain_mlstm": 0, "plain_slstm": 0}
    seconds = {"train_local": 0.0, "evaluate": 0.0, "signature": 0.0}
    signatures, accs = [], []

    def counted(name, fn, keep=None):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            calls[name] += 1
            if name in seconds:
                seconds[name] += time.perf_counter() - t
            if keep is not None:
                keep.append(out)
            return out
        return wrapper

    inner = (fa.flash_attention_plain, sig.signature_counts_plain,
             ss.selective_scan_plain, ml.mlstm_chunkwise_plain,
             sl.slstm_scan_plain)
    backend.train_local = counted("train_local", backend.train_local)
    backend.evaluate = counted("evaluate", backend.evaluate, accs)
    backend.signature = counted("signature", backend.signature, signatures)
    fa.flash_attention_plain = counted("plain_flash", inner[0])
    sig.signature_counts_plain = counted("plain_signature", inner[1])
    ss.selective_scan_plain = counted("plain_scan", inner[2])
    ml.mlstm_chunkwise_plain = counted("plain_mlstm", inner[3])
    sl.slstm_scan_plain = counted("plain_slstm", inner[4])
    coord = DagAflCoordinator(backend, client_data, global_test,
                              DagAflConfig(n_clients=clients, max_rounds=2,
                                           local_epochs=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (sig, fa, ss, ml, sl):              # counts start here
        mod.launches = 0
    fa.launches_sm90 = fa.launches_fma = 0
    sig.launches_vec = sig.launches_strided = 0
    t0 = time.perf_counter()
    result = coord.run(init_model=genesis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"signature": sig.launches, "flash": fa.launches,
                "scan": ss.launches, "mlstm": ml.launches,
                "slstm": sl.launches}              # and are read here
    flash_routes = {"sm90": fa.launches_sm90, "fma": fa.launches_fma}
    sig_routes = {"vec": sig.launches_vec, "strided": sig.launches_strided}
    (fa.flash_attention_plain, sig.signature_counts_plain,
     ss.selective_scan_plain, ml.mlstm_chunkwise_plain,
     sl.slstm_scan_plain) = inner
    seconds["rest"] = wall - sum(seconds.values())
    peak = torch.cuda.max_memory_allocated()

    rounds = result.rounds
    accs += [result.final_accuracy, result.best_accuracy,
             result.extra["tip_mean_accuracy"],
             result.extra["client_mean_accuracy"]]
    accs += [a for _, a in result.history]
    gm = coord.global_model()
    ok, why = verify_full_dag(coord.ledger)
    forwards = calls["evaluate"] + calls["signature"]
    kinds = [spec.kind for spec in cfg.layer_specs()]
    expected = {"signature": calls["signature"],
                "flash": kinds.count("attn") * forwards,
                "scan": kinds.count("mamba") * forwards,
                "mlstm": kinds.count("mlstm") * forwards,
                "slstm": kinds.count("slstm") * forwards}
    check(rounds == 2 * clients,
          f"{phase}: expected {2 * clients} rounds, got {rounds}")
    check(result.extra["chain_len"] == 1 + rounds,
          f"{phase}: chain_len {result.extra['chain_len']} != 1 + {rounds}")
    check(result.extra["verify_failures"] == 0, f"{phase}: path "
          f"verification")
    check(ok, f"{phase}: verify_full_dag: {why}")
    check(launches == expected and calls["signature"] == rounds,
          f"{phase}: launches {launches}, expected {expected} for "
          f"{forwards} eval and signature forwards and "
          f"{calls['signature']} signature calls")
    check(flash_routes == {"sm90": launches["flash"], "fma": 0},
          f"{phase}: flash launches by route {flash_routes}: every one "
          f"of the {launches['flash']} must take the sm90 kernel")
    check(sig_routes == {"vec": launches["signature"], "strided": 0},
          f"{phase}: signature launches by route {sig_routes}: every one "
          f"of the {launches['signature']} must take the vec kernel")
    check(not any(n for name, n in calls.items()
                  if name.startswith("plain_")),
          f"{phase}: the path ran a plain kernel version: {calls}")
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
          f"{phase}: accuracies {accs}")
    check(all(p.is_cuda for p in tree_leaves(gm)), f"{phase}: model left "
          f"the card")
    check(all(s.shape == (64,) and np.all((s >= 0) & (s <= 1))
              for s in signatures), f"{phase}: signatures are not 64 "
          f"fractions")
    ref = lm_reference_check(tfm, cfg, backend, gm, global_test,
                             checked=reference_compute is None)
    if reference_compute is not None:
        ref[reference_compute] = lm_reference_check(
            tfm, dataclasses.replace(cfg, compute_dtype=reference_compute),
            backend, gm, global_test)
    ref["profile"] = profile_lm_round(backend, gm, streams[0])
    record = dict(
        phase=phase, model=cfg.name,
        layers=[spec.kind for spec in cfg.layer_specs()],
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        data_vocab=LM_DATA_VOCAB, batch=8, seq_len=512,
        local_steps=local_steps, n_params=n_params,
        clients=clients, rounds=rounds, chain_len=result.extra["chain_len"],
        wall_s=wall, s_per_round=wall / rounds, peak_bytes=peak,
        remat=Runtime().remat,
        # DagAflConfig(local_epochs=2): two SGD steps a train_local call
        train_local_ms_per_step=1e3 * seconds["train_local"]
        / (2 * max(calls["train_local"], 1)),
        sim_time=result.sim_time, data_s=data_s, init_s=init_s,
        final_accuracy=result.final_accuracy,
        tip_mean_accuracy=result.extra["tip_mean_accuracy"],
        client_mean_accuracy=result.extra["client_mean_accuracy"],
        calls=calls, seconds=seconds, launches=launches,
        flash_routes=flash_routes, signature_routes=sig_routes,
        verify_full_dag=why, **ref)
    emit(**record)
    return record


# LM cohort legs: (leg, config, clients, cohort_size, batch, parameters,
# the compute type the window's training is held in); the sizes keep each
# leg's peak under the card's 80 GB (PERF.md section 4).  The xLSTM
# stack's backward amplifies rounding: in bfloat16 one step's gradients
# differ by 20-50% between two product orders, and a one-ulp change of
# the start moves the trained leaves further than training moves them,
# so no rerun can check that window.  It is held against the sequential
# calls with float32 products (floor 8x below the leaves' move), and the
# bfloat16 difference, floor and gradients are reported beside it
LM_COHORT_LEGS = (("lm_cohort", "lm", 3, 2, 8, 630_736_896, None),
                  ("hybrid_cohort", "hybrid", 2, 2, 4, HYBRID_PARAMS, None),
                  ("xlstm_cohort", "xlstm", 3, 3, 8, XLSTM_LOOP_PARAMS,
                   "float32"))
LM_COHORT_TRAIN_TOL = 5e-3           # trained leaves, window vs train_local
# ... and within this many times the training's own one-ulp floor (the
# trained leaves' move when the start moves one float32 ulp, ``ulp_floor``)
LM_COHORT_FLOOR_FACTOR = 2.0
TRAIN_STEPS = 10                     # the train path's AdamW steps


def lm_streams(clients: int):
    """launch/train.py's streams over the LM paths' sub-vocabulary: one a
    client, and the global test stream."""
    from repro_torch.data.synthetic import make_lm_dataset
    streams = [make_lm_dataset(vocab=LM_DATA_VOCAB, n_tokens=50_000,
                               order=1.5 + 0.5 * c, seed=c)
               for c in range(clients)]
    return streams, make_lm_dataset(vocab=LM_DATA_VOCAB, n_tokens=50_000,
                                    seed=999)


def window_train_err(backend, agg, datasets, seeds, epochs, trained):
    """A window's trained leaves against the same clients trained one by
    one by ``backend.train_local``: the largest difference, the largest
    change of any leaf in training, and the three leaves that differ most
    (each with its own largest change)."""
    from repro_torch.core.aggregate import tree_map
    from repro_torch.train.checkpoint import _walk
    err, change = {}, {}
    for k, (ds, seed) in enumerate(zip(datasets, seeds)):
        solo, _ = backend.train_local(tree_map(lambda l: l[k], agg), ds,
                                      seed=seed, epochs=epochs)
        for (path, a), (_, b), (_, s0) in zip(_walk(solo), _walk(trained),
                                              _walk(agg)):
            err[path] = max(err.get(path, 0.0),
                            (a - b[k]).abs().max().item())
            change[path] = max(change.get(path, 0.0),
                               (b[k] - s0[k]).abs().max().item())
        del solo
    worst = sorted(err, key=err.get, reverse=True)[:3]
    return {"max_abs_err": max(err.values()),
            "max_change": max(change.values()),
            "worst_leaves": [{"leaf": p, "max_abs_err": err[p],
                              "max_change": change[p]} for p in worst]}


def ulp_floor(backend, agg, ds, seed, epochs) -> float:
    """How far ``train_local``'s trained leaves move when every leaf of its
    start moves one float32 ulp: the training's own rounding floor."""
    import torch
    from repro_torch.core.aggregate import tree_leaves, tree_map
    start = tree_map(lambda l: l[0], agg)
    up = tree_map(lambda l: torch.nextafter(l, torch.full_like(l, 1e30)),
                  start)
    a, _ = backend.train_local(start, ds, seed=seed, epochs=epochs)
    b, _ = backend.train_local(up, ds, seed=seed, epochs=epochs)
    return max((x - y).abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def grad_by_layer(backend, programs, agg, datasets, seeds) -> dict:
    """One training step from the window's start on its first batches: the
    window's gradients (``vmap`` of ``loss_fn``, the K losses summed)
    against each client's own ``loss_fn`` gradient, as the largest
    difference over the largest gradient, per layer in the forward's
    order (a stage leaf's leading axis is its period)."""
    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_map
    from repro_torch.models import transformer as tfm
    from repro_torch.train.checkpoint import _walk
    toks = [programs.client_batches(ds, seed, 1)[0][0]
            for ds, seed in zip(datasets, seeds)]
    x = torch.from_numpy(np.stack(toks)).to(backend.device)
    y = x[:, :, 1:]
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), agg)
    rows = torch.ones(x.shape[1], device=x.device)
    programs.sum_loss(params, x, y, rows,
                      programs.loss_denom(rows, y[0])).sum().backward()
    diff, scale = {}, {}
    for k, tk in enumerate(toks):
        solo = tree_map(lambda p: p[k].detach().clone().requires_grad_(True),
                        agg)
        tfm.loss_fn(solo, backend._batch(tk), backend.cfg)[0].backward()
        for (path, w), (_, one) in zip(_walk(params), _walk(solo)):
            parts = path.split("/")
            if parts[0] == "stages":        # (stage, period, block)
                pairs = [((1, parts[1], i, parts[2]), a, b) for i, (a, b)
                         in enumerate(zip(w.grad[k], one.grad))]
            else:                           # embedding, final norm, head
                rank = {"embed/embedding": 0, "embed/unembed": 3}
                pairs = [((rank.get(path, 2), path), w.grad[k], one.grad)]
            for key, a, b in pairs:
                diff[key] = max(diff.get(key, 0.0),
                                (a - b).abs().max().item())
                scale[key] = max(scale.get(key, 0.0), b.abs().max().item())
        del solo

    def name(key):
        return (f"stage{key[1][1:-1]}.period{key[2]}.{key[3]}"
                if key[0] == 1 else key[1])
    return {name(key): diff[key] / max(scale[key], 1e-30)
            for key in sorted(diff)}


def argmax_grids(fn, *args):
    """``fn(*args)`` and the argmax token grid of every ``tfm.forward`` it
    ran."""
    from repro_torch.models import transformer as tfm
    inner, grids = tfm.forward, []

    def forward(*a, **kw):
        logits, aux = inner(*a, **kw)
        grids.append(logits.argmax(-1))
        return logits, aux

    tfm.forward = forward
    try:
        return fn(*args), grids
    finally:
        tfm.forward = inner


def lm_cohort_parity(backend, engine, window, leg: str,
                     reference_compute=None) -> dict:
    """One window of the counted run done again by the sequential calls on
    the card.  Training: its aggregates and seeds through ``train_local``,
    trained leaves within LM_COHORT_TRAIN_TOL and within
    LM_COHORT_FLOOR_FACTOR times the training's one-ulp floor
    (``ulp_floor``), reported beside the largest change of a leaf; with
    ``reference_compute``, both are redone with the products in that type
    and held there, the config's own difference is reported, and so is
    one step's gradient difference per layer in both types
    (``grad_by_layer``).  Validation: the window's forwards redone give
    its accuracies again and the same argmax token at every position as
    ``evaluate``'s forward.  Signatures: within one flag of a row,
    1/(S*w), per bucket, of ``signature``'s."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_map
    from repro_torch.fl.backend import LMBackend
    from repro_torch.fl.cohort import CohortBackend

    agg, datasets, seeds, epochs = window["train_in"]
    trained = window["trained"]
    own = window_train_err(backend, agg, datasets, seeds, epochs, trained)
    own["compute_dtype"] = backend.cfg.compute_dtype
    own["ulp_floor"] = ulp_floor(backend, agg, datasets[0], seeds[0],
                                 epochs)
    held = own
    if reference_compute is not None:
        ref = LMBackend(dataclasses.replace(backend.cfg,
                                            compute_dtype=reference_compute),
                        lr=3e-3, local_steps=epochs,
                        batch_size=backend.batch_size,
                        seq_len=backend.seq_len, device=backend.device)
        ref_engine = CohortBackend(ref, overlap=False)
        ref_trained, _ = ref_engine.train_cohort_stacked(agg, datasets,
                                                         seeds, epochs)
        held = window_train_err(ref, agg, datasets, seeds, epochs,
                                ref_trained)
        del ref_trained
        held["compute_dtype"] = reference_compute
        held["ulp_floor"] = ulp_floor(ref, agg, datasets[0], seeds[0],
                                      epochs)
        held["grad_by_layer"] = grad_by_layer(ref, ref_engine.programs, agg,
                                              datasets, seeds)
        own["grad_by_layer"] = grad_by_layer(backend, engine.programs, agg,
                                             datasets, seeds)
        torch.cuda.empty_cache()
    held["tolerance"] = min(LM_COHORT_TRAIN_TOL,
                            LM_COHORT_FLOOR_FACTOR * held["ulp_floor"])
    check(held["max_abs_err"] <= held["tolerance"],
          f"{leg}: trained leaves differ from train_local's by "
          f"{held['max_abs_err']} (> {held['tolerance']}, "
          f"{held['compute_dtype']} products; one-ulp floor "
          f"{held['ulp_floor']}, the leaves moved up to "
          f"{held['max_change']})")
    val_sets, accs = window["evaluated"]
    again, grids = argmax_grids(engine.evaluate_cohort_stacked, trained,
                                val_sets)
    check(again == list(accs), f"{leg}: the window's forwards redone give "
          f"accuracies {again}, the run {list(accs)}")
    n = backend.batch_size * backend.seq_len
    differing = []
    for k, ds in enumerate(val_sets):
        acc, want = argmax_grids(backend.evaluate,
                                 tree_map(lambda l: l[k], trained), ds)
        differing.append(int((grids[k] != want[0]).sum()))
        check(grids[k].shape == want[0].shape and differing[-1] == 0
              and round(acc * n) == round(accs[k] * n),
              f"{leg}: client {k}'s argmax tokens differ from evaluate's at "
              f"{differing[-1]} positions (accuracy {accs[k]} against "
              f"{acc})")
    row_flag = 1.0 / (backend.seq_len * -(-backend.cfg.d_model // 64))
    sig_sets, sigs = window["signed"]
    sig_err, buckets = 0.0, 0
    for k, (ds, got) in enumerate(zip(sig_sets, sigs)):
        want = backend.signature(tree_map(lambda l: l[k], trained), ds)
        sig_err = max(sig_err, float(np.abs(got - want).max()))
        buckets += int(np.sum(got != want))
    check(sig_err <= row_flag, f"{leg}: signatures differ from "
          f"signature's by {sig_err} (> 1/(S*w) = {row_flag})")
    return {"clients": len(seeds), "train": own, "train_held": held,
            "argmax_positions": int(grids[0].numel()),
            "argmax_positions_differing": differing,
            "accuracies": list(accs),
            "signature_max_abs_err": sig_err,
            "signature_tolerance": row_flag,
            "signature_buckets_differing": buckets}


def lm_cohort_leg(kern, dev, *, leg, cfg, clients, cohort_size, batch,
                  expected_params, seq_s_per_round,
                  reference_compute=None) -> dict:
    """The DAG-AFL loop over ``clients`` ``LMBackend`` clients on the cohort
    engine (``LMCohortPrograms``): 2 rounds a client of 2 local steps, 512
    positions, ``cohort_window=2.0``, timed by engine call, with every
    kernel's launch count set to 0 just before the run and read just
    after; then one window redone by the sequential calls
    (``lm_cohort_parity``)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.fl.backend import LMBackend
    from repro_torch.fl.cohort import CohortBackend, LMCohortPrograms

    sig, fa, ss, ml, sl = (kern[k] for k in ("sig", "fa", "ss", "ml",
                                               "sl"))
    mods = {"signature": sig, "flash": fa, "scan": ss, "mlstm": ml,
            "slstm": sl}
    gc.collect()
    torch.cuda.empty_cache()
    streams, global_test = lm_streams(clients)
    client_data = [{"train": s, "val": s, "test": s} for s in streams]
    backend = LMBackend(cfg, lr=3e-3, local_steps=2, batch_size=batch,
                        seq_len=512)
    check(backend.device.type == "cuda", f"{leg}: backend is not on the "
          f"card")
    engine = CohortBackend(backend)
    check(isinstance(engine.programs, LMCohortPrograms), f"{leg}: the "
          f"engine took {type(engine.programs).__name__}")
    genesis = backend.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(genesis))
    check(n_params == tree_param_count(cfg) == expected_params,
          f"{leg}: {n_params} parameters, expected {expected_params}")
    # warm-up outside the counted run: one window of the run's width and
    # one sequential step (a window of one trains sequentially), cuBLAS
    # handles and allocator pools
    warm, _ = engine.train_cohort([genesis] * cohort_size,
                                  streams[:cohort_size], [0] * cohort_size,
                                  epochs=1)
    engine.evaluate_cohort(warm, streams[:cohort_size])
    engine.signature_cohort(warm, streams[:cohort_size])
    del warm
    warm, _ = backend.train_local(genesis, streams[0], epochs=1)
    backend.evaluate(warm, streams[0])
    backend.signature(warm, streams[0])
    del warm

    engine_calls = ("train_cohort_stacked", "evaluate_cohort_stacked",
                    "signature_cohort_stacked", "evaluate_many",
                    "evaluate_shared")
    backend_calls = ("train_local", "evaluate", "signature")
    calls = {name: 0 for name in engine_calls + backend_calls}
    seconds = {name: 0.0 for name in engine_calls + backend_calls}
    plain = {name: 0 for name in mods}
    depth, last_s = [0], {}
    window, forwards, windows, steps = {}, [0], [], []
    signatures, accs = [], []

    def counted(name, fn, keep=None):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            calls[name] += 1
            last_s[name] = time.perf_counter() - t
            if depth[0] == 0:
                seconds[name] += last_s[name]
            if keep is not None:
                keep(args, out)
            return out
        return wrapper

    def keep_train(args, out):
        steps.append({"clients": len(args[1]),
                      "seconds": last_s["train_cohort_stacked"]})
        window.setdefault("train_in", args[:3] + (2,))
        window.setdefault("trained", out[0])

    def keep_engine(key, found):
        def keep(args, out):
            found.extend(out)
            forwards[0] += len(args[1])
            window.setdefault(key, (args[1], out))
        return keep

    def keep_many(args, out):
        accs.extend(out)
        if len(args[0]) > engine.programs.eval_many_min_batch:
            forwards[0] += len(args[0])

    def keep_one(found):
        def keep(args, out):
            found.append(out)
            forwards[0] += 1
        return keep

    def keep_shared(args, out):
        accs.extend(out)
        forwards[0] += 1                   # the K shards in one forward

    def plain_counted(name, fn):
        def wrapper(*args, **kwargs):
            plain[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    inner = (fa.flash_attention_plain, sig.signature_counts_plain,
             ss.selective_scan_plain, ml.mlstm_chunkwise_plain,
             sl.slstm_scan_plain)
    engine.train_cohort_stacked = counted(
        "train_cohort_stacked", engine.train_cohort_stacked, keep_train)
    engine.evaluate_cohort_stacked = counted(
        "evaluate_cohort_stacked", engine.evaluate_cohort_stacked,
        keep_engine("evaluated", accs))
    engine.signature_cohort_stacked = counted(
        "signature_cohort_stacked", engine.signature_cohort_stacked,
        keep_engine("signed", signatures))
    engine.evaluate_many = counted("evaluate_many", engine.evaluate_many,
                                   keep_many)
    engine.evaluate_shared = counted("evaluate_shared",
                                     engine.evaluate_shared, keep_shared)
    backend.train_local = counted("train_local", backend.train_local)
    backend.evaluate = counted("evaluate", backend.evaluate, keep_one(accs))
    backend.signature = counted("signature", backend.signature,
                                keep_one(signatures))
    fa.flash_attention_plain = plain_counted("flash", inner[0])
    sig.signature_counts_plain = plain_counted("signature", inner[1])
    ss.selective_scan_plain = plain_counted("scan", inner[2])
    ml.mlstm_chunkwise_plain = plain_counted("mlstm", inner[3])
    sl.slstm_scan_plain = plain_counted("slstm", inner[4])
    coord = DagAflCoordinator(
        backend, client_data, global_test,
        DagAflConfig(n_clients=clients, max_rounds=2, local_epochs=2,
                     cohort_size=cohort_size, cohort_window=2.0),
        cohort_engine=engine)
    check(coord.cohort is engine, f"{leg}: the coordinator took no cohort "
          f"engine")
    flush = coord._window.flush_fn

    def counted_flush(batch_):
        windows.append(len(batch_))
        flush(batch_)

    coord._window.flush_fn = counted_flush
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():                      # counts start here
        mod.launches = 0
    fa.launches_sm90 = fa.launches_fma = 0
    sig.launches_vec = sig.launches_strided = 0
    t0 = time.perf_counter()
    result = coord.run(init_model=genesis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in mods.items()}
    flash_routes = {"sm90": fa.launches_sm90, "fma": fa.launches_fma}
    sig_routes = {"vec": sig.launches_vec, "strided": sig.launches_strided}
    (fa.flash_attention_plain, sig.signature_counts_plain,
     ss.selective_scan_plain, ml.mlstm_chunkwise_plain,
     sl.slstm_scan_plain) = inner                  # and are read here
    seconds["rest"] = wall - sum(seconds.values())
    run_calls, run_seconds, run_forwards = dict(calls), dict(seconds), \
        forwards[0]
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)

    rounds = result.rounds
    batched = sum(n for n in windows if n > 1)
    accs += [result.final_accuracy, result.best_accuracy,
             result.extra["tip_mean_accuracy"],
             result.extra["client_mean_accuracy"]]
    accs += [a for _, a in result.history]
    ok, why = verify_full_dag(coord.ledger)
    kinds = [spec.kind for spec in cfg.layer_specs()]
    expected = {"signature": rounds,
                "flash": kinds.count("attn") * run_forwards,
                "scan": kinds.count("mamba") * run_forwards,
                "mlstm": kinds.count("mlstm") * run_forwards,
                "slstm": kinds.count("slstm") * run_forwards}
    check(rounds == 2 * clients,
          f"{leg}: expected {2 * clients} rounds, got {rounds}")
    check(result.extra["chain_len"] == 1 + rounds,
          f"{leg}: chain_len {result.extra['chain_len']} != 1 + {rounds}")
    check(result.extra["verify_failures"] == 0, f"{leg}: path verification")
    check(ok, f"{leg}: verify_full_dag: {why}")
    check(max(windows, default=0) >= 2 and "train_in" in window
          and result.extra["cohorts_dispatched"] >= 1,
          f"{leg}: no window of 2 or more clients (windows {windows})")
    # one signature launch a round: a client of a window, or one alone
    check(launches == expected
          and rounds == batched + run_calls["signature"],
          f"{leg}: launches {launches}, expected {expected} for "
          f"{run_forwards} eval and signature forwards, {rounds} rounds "
          f"({batched} in windows)")
    check(flash_routes == {"sm90": launches["flash"], "fma": 0},
          f"{leg}: flash launches by route {flash_routes}: every one of the "
          f"{launches['flash']} must take the sm90 kernel")
    check(sig_routes == {"vec": launches["signature"], "strided": 0},
          f"{leg}: signature launches by route {sig_routes}: every one of "
          f"the {launches['signature']} must take the vec kernel")
    check(not any(plain.values()), f"{leg}: the path ran a plain kernel "
          f"version: {plain}")
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs),
          f"{leg}: accuracies {accs}")
    check(all(np.shape(s) == (64,) and np.all((s >= 0) & (s <= 1))
              for s in signatures) and len(signatures) == rounds,
          f"{leg}: signatures are not {rounds} rows of 64 fractions")
    check(all(p.is_cuda for p in tree_leaves(coord.global_model())),
          f"{leg}: model left the card")
    parity = lm_cohort_parity(backend, engine, window, leg,
                              reference_compute)
    record = dict(
        phase="lm_cohort_path", leg=leg, model=cfg.name,
        layers=kinds, d_model=cfg.d_model, vocab=cfg.vocab_size,
        data_vocab=LM_DATA_VOCAB, batch=batch, seq_len=512, local_steps=2,
        n_params=n_params, clients=clients, cohort_size=cohort_size,
        cohort_window=2.0, rounds=rounds,
        chain_len=result.extra["chain_len"],
        cohorts_dispatched=result.extra["cohorts_dispatched"],
        windows=windows, rounds_in_windows=batched, window_steps=steps,
        wall_s=wall, s_per_round=wall / rounds, peak_bytes=peak,
        alloc_retries=retries, sequential_s_per_round=seq_s_per_round,
        ratio_to_sequential=wall / rounds / seq_s_per_round,
        final_accuracy=result.final_accuracy,
        tip_mean_accuracy=result.extra["tip_mean_accuracy"],
        calls=run_calls, seconds=run_seconds, forwards=run_forwards,
        launches=launches, flash_routes=flash_routes,
        signature_routes=sig_routes, verify_full_dag=why, parity=parity)
    emit(**record)
    del coord, engine, backend, genesis, window
    return record


def phase_lm_cohort_path(kern, dev, sequential: dict) -> dict:
    """The three LM families on the cohort engine (LM_COHORT_LEGS), each
    against its sequential path's seconds a round from this call."""
    configs = {"lm": lm_config, "hybrid": hybrid_config,
               "xlstm": xlstm_loop_config}
    return {leg: lm_cohort_leg(
        kern, dev, leg=leg, cfg=configs[family](), clients=clients,
        cohort_size=size, batch=batch, expected_params=n_params,
        seq_s_per_round=sequential[family]["s_per_round"],
        reference_compute=held)
        for leg, family, clients, size, batch, n_params, held
        in LM_COHORT_LEGS}


def optimizer_steps_on_card(dev) -> dict:
    """One SGD (momentum 0.9, weight decay 0.01) and one AdamW (weight
    decay 0.1) step on 4,096 float32 parameters, on the card and on the
    CPU: the parameters and moments must be bit-equal (the CPU's equal
    the jitted reference's; CUDA's ``add`` with ``alpha`` must be the
    same fused multiply-add)."""
    import numpy as np
    import torch
    from repro_torch.optim import optimizers as topt
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal(4096) * 0.5).astype(np.float32))
    out = {}
    for name, make in (("sgd", lambda: topt.sgd(0.05, 0.9, 0.01)),
                       ("adamw", lambda: topt.adamw(1e-2,
                                                    weight_decay=0.1))):
        got = []
        for device in ("cpu", dev):
            opt, p = make(), p0.clone().to(device)
            state = opt.init(p)
            upd, state = opt.update(g.to(device), state, p)
            topt.apply_updates(p, upd)
            moments = [state[k].cpu() for k in ("mu", "m", "v")
                       if k in state]
            got.append([p.cpu()] + moments)
        differ = [int((a != b).sum()) for a, b in zip(*got)]
        check(not any(differ), f"train_path: one {name} step on the card "
              f"differs from the CPU's in {differ} values")
        out[name] = differ
    return out


def phase_train_path(kern, dev) -> dict:
    """``launch/train.train_single`` on ``lm_config()``: TRAIN_STEPS AdamW
    steps (clip 1.0, the signature in the metrics) over a TokenPipeline of
    the LM paths' sub-vocabulary, batch 8 x 512, with every kernel's launch
    count set to 0 just before and read just after; then a checkpoint
    round trip and one eval step."""
    import argparse
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch
    from repro_torch.runtime import Runtime
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.step import make_eval_step

    sig = kern["sig"]
    others = {k: kern[k] for k in ("fa", "ss", "ml", "sl")}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = lm_config()
    t0 = time.perf_counter()
    pipe = TokenPipeline(LM_DATA_VOCAB, 8, 512, seed=0)
    data_s = time.perf_counter() - t0
    args = argparse.Namespace(steps=TRAIN_STEPS, batch=8, seq=512, seed=0,
                              device=str(dev), log_every=TRAIN_STEPS,
                              checkpoint="")
    history, plain = [], [0]
    inner = sig.signature_counts_plain

    def plain_counted(*a, **kw):
        plain[0] += 1
        return inner(*a, **kw)

    sig.signature_counts_plain = plain_counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sig.launches = sig.launches_vec = sig.launches_strided = 0
    for mod in others.values():                    # counts start here
        mod.launches = 0
    t0 = time.perf_counter()
    params = launch.train_single(cfg, args, pipe=pipe, history=history)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"signature": sig.launches,
                **{k: m.launches for k, m in others.items()}}
    routes = {"vec": sig.launches_vec, "strided": sig.launches_strided}
    sig.signature_counts_plain = inner             # and are read here
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in history]
    step_s = [h["seconds"] for h in history]
    check(len(history) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"train_path: losses {losses}")
    check(float(np.mean(losses[-3:])) < losses[0], f"train_path: the mean "
          f"loss of the last 3 steps {np.mean(losses[-3:])} is not below "
          f"step 0's {losses[0]}")
    check(launches == {"signature": TRAIN_STEPS, "fa": 0, "ss": 0, "ml": 0,
                       "sl": 0} and plain[0] == 0,
          f"train_path: launches {launches} (plain {plain[0]}): one "
          f"signature launch a step and nothing else")
    check(routes == {"vec": TRAIN_STEPS, "strided": 0},
          f"train_path: signature launches by route {routes}")
    check(all(np.shape(h["signature"]) == (64,) for h in history),
          "train_path: signature metric is not 64 fractions")
    ckpt = ROOT / "build" / "chip_smoke_train.npz"
    t0 = time.perf_counter()
    save_checkpoint(str(ckpt), params, step=TRAIN_STEPS)
    restored, step = load_checkpoint(str(ckpt), params)
    ckpt_s = time.perf_counter() - t0
    same = step == TRAIN_STEPS and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(tree_leaves(restored), tree_leaves(params)))
    ckpt_bytes = ckpt.stat().st_size
    ckpt.unlink()
    check(same, "train_path: the checkpoint round trip is not bit-equal")
    del restored
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_dict(next(iter(pipe))).items()}
    acc = float(make_eval_step(cfg, Runtime(use_kernels=True))(
        params, batch)["accuracy"])
    check(np.isfinite(acc) and 0.0 <= acc <= 1.0,
          f"train_path: eval accuracy {acc}")
    ms = 1e3 * float(np.mean(step_s[1:]))
    opt_bits = optimizer_steps_on_card(dev)
    record = dict(
        phase="train_path", model=cfg.name, optimizer="adamw",
        remat=Runtime().remat, optimizer_step_card_vs_cpu_differ=opt_bits,
        clip_norm=1.0, batch=8, seq_len=512, data_vocab=LM_DATA_VOCAB,
        steps=TRAIN_STEPS, losses=losses,
        grad_norms=[h["grad_norm"] for h in history],
        step_ms=[1e3 * s for s in step_s], ms_per_step=ms,
        tokens_per_s=8 * 512 / (ms / 1e3), wall_s=wall, data_s=data_s,
        peak_bytes=peak, launches=launches, signature_routes=routes,
        checkpoint_bytes=ckpt_bytes, checkpoint_s=ckpt_s,
        eval_accuracy=acc)
    emit(**record)
    del params
    return record


SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 64   # the serve path
SERVE_LOGIT_TOL = 2e-2    # the reference's decode bound
SERVING_QUERIES = 12      # expected queries over a path's simulated time


class PlainMeter:
    """Counts calls of every kernel's plain version while it is entered
    (a path must launch the kernels, never fall back), and restores
    them on exit."""
    NAMES = (("fa", "flash_attention_plain"), ("sig", "signature_counts_plain"),
             ("ss", "selective_scan_plain"), ("ml", "mlstm_chunkwise_plain"),
             ("sl", "slstm_scan_plain"))

    def __init__(self, kern):
        self.kern = kern
        self.calls = {name: 0 for _, name in self.NAMES}

    def __enter__(self):
        self.inner = {}
        for key, name in self.NAMES:
            mod = self.kern[key]
            fn = getattr(mod, name)
            self.inner[key] = fn

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for key, name in self.NAMES:
            setattr(self.kern[key], name, self.inner[key])


class RoutingMeter:
    """While entered, records each MoE routing (every call of
    ``models.moe.topk_dispatch``): its greedy top-k choices (G, S_g, k),
    the reference's rule (the first largest probability, then the first
    largest of the rest), the choices its capacity dropped, and which
    tokens kept all k choices (G, S_g); restores the function on exit."""

    def __init__(self):
        self.choices, self.dropped, self.kept = [], [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.inner = moe, moe.topk_dispatch

        def routed(probs, k, cap):
            gates, dispatch = self.inner(probs, k, cap)
            with torch.no_grad():
                rest, picks = probs.detach(), []
                for _ in range(k):
                    picks.append(rest.argmax(-1))
                    rest = rest.scatter(-1, picks[-1][..., None], 0.0)
                self.choices.append(torch.stack(picks, -1))
                self.dropped.append(k * probs.shape[0] * probs.shape[1]
                                    - dispatch.sum())
                self.kept.append(dispatch.any(-1).sum(-1) == k)
            return gates, dispatch

        moe.topk_dispatch = routed
        return self

    def __exit__(self, *exc):
        self.moe.topk_dispatch = self.inner

    def tokens(self, calls, batch: int, seq: int, record=None):
        """The choices of ``calls`` (indices into the record) as (layers,
        batch, seq, k), or with ``record=self.kept`` whether each token
        kept them all (layers, batch, seq, 1): each call's groups cut
        back to the batch's rows."""
        import torch
        record = self.choices if record is None else record
        return torch.stack([record[i].reshape(-1, *record[i].shape[2:])
                            [:batch * seq].reshape(batch, seq, -1)
                            for i in calls])

    def dropped_total(self) -> int:
        return int(sum(int(d) for d in self.dropped))


def moe_layers(cfg) -> int:
    return sum(spec.ffn == "moe" for spec in cfg.layer_specs())


def routed_choices(cfg, tokens: int) -> int:
    """Routed choices of ``tokens`` tokens over the MoE layers."""
    return tokens * cfg.moe.top_k * moe_layers(cfg)


def reset_launches(kern) -> None:
    for key in ("sig", "fa", "ss", "ml", "sl"):
        kern[key].launches = 0
    kern["fa"].launches_sm90 = kern["fa"].launches_fma = 0
    kern["fa"].launches_by_window.clear()
    kern["sig"].launches_vec = kern["sig"].launches_strided = 0


def read_launches(kern) -> dict:
    fa, sig = kern["fa"], kern["sig"]
    return {"launches": {"signature": sig.launches, "flash": fa.launches,
                         "scan": kern["ss"].launches,
                         "mlstm": kern["ml"].launches,
                         "slstm": kern["sl"].launches},
            "flash_routes": {"sm90": fa.launches_sm90,
                             "fma": fa.launches_fma},
            "flash_windows": dict(sorted(fa.launches_by_window.items())),
            "signature_routes": {"vec": sig.launches_vec,
                                 "strided": sig.launches_strided}}


def expected_prefill_launches(cfg, prefills: int, signatures: int = 0,
                              forwards: int = 0) -> dict:
    """Kernel launches of ``prefills`` serve prefills and ``forwards``
    eval and signature forwards: one a layer of the kernel's kind, and
    one signature launch a signature call."""
    kinds = [spec.kind for spec in cfg.layer_specs()]
    n = prefills + forwards
    return {"signature": signatures, "flash": kinds.count("attn") * n,
            "scan": kinds.count("mamba") * n,
            "mlstm": kinds.count("mlstm") * n,
            "slstm": kinds.count("slstm") * n}


def expected_flash_windows(cfg, seq_len: int, forwards: int) -> dict:
    """Flash launches by sliding window (-1 for none) of ``forwards``
    forwards over ``seq_len`` tokens: one an attention layer, at the
    window the model resolves for it."""
    from repro_torch.models.transformer import resolve_window
    want = {}
    for spec in cfg.layer_specs():
        if spec.kind == "attn":
            w = resolve_window(cfg, spec, seq_len)
            w = w if w > 0 else -1
            want[w] = want.get(w, 0) + forwards
    return dict(sorted(want.items()))


def attn_cache_lens(cfg, caches) -> list:
    """The sequence length of every attention layer's self-attention
    cache entries (not the cross caches ``xk``, ``xv`` over the
    encoder's frames)."""
    from repro_torch.models.attention import (KV_CACHE_TRAILING_DIMS,
                                              cache_seq_axis)
    lens = []
    for si, stage in enumerate(cfg.stages):
        for j, spec in enumerate(stage.pattern):
            if spec.kind == "attn":
                for key, a in caches[si][f"l{j}"].items():
                    if key in KV_CACHE_TRAILING_DIMS:
                        lens.append(a.shape[cache_seq_axis(key, a.dim())])
    return lens


def cross_caches(caches) -> list:
    """Every cross-attention layer's ``xk`` and ``xv``, in layer order."""
    return [a for stage in caches for layer in stage.values()
            for key, a in sorted(layer.items()) if key in ("xk", "xv")]


def serve_leg(kern, dev, leg: str, cfg, expected_params: int,
              batch: int = SERVE_BATCH, prompt_len: int = SERVE_PROMPT,
              new_tokens: int = SERVE_NEW,
              phase: str = "serve_path") -> dict:
    """``launch.serve.serve`` at full width: weights and prompts from seed
    0, by default batch 8, a 512-token prompt and 64 new tokens, in
    ``cfg``'s compute type, with the launch counts set to 0 just before
    and read just after (a warm-up call first).  Then the same weights and
    prompts in float32 compute, each step's logits held against a
    teacher-forced full forward (the models' own plain forms) within the
    reference's 2e-2 on the steps that every MoE layer routed alike and
    kept whole in both runs, and the greedy tokens against its argmax
    where the top-2 gap exceeds twice the largest error; the bfloat16
    run's readings beside it.  A config with an encoder also draws its
    frame embeddings from seed 0 (after the prompts, as ``serve`` does)
    and feeds them to every run and forward (the flash count, one a
    decoder attention layer, leaves none to the encoder), and its decode
    profile holds the cross caches bit for bit across the decode
    steps."""
    import dataclasses
    import gc

    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import unembed
    from repro_torch.runtime import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tfm.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    enc = None if cfg.encoder is None else torch.randn(
        (batch, cfg.encoder.n_ctx, cfg.d_model), generator=gen,
        device=dev) * 0.1
    extra = {} if enc is None else {"enc_embed": enc}
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == tree_param_count(cfg) == expected_params,
          f"{leg}: {n_params} parameters, expected {expected_params}")
    # warm-up outside the counted run: cuBLAS handles, allocator pools
    launch.serve(cfg, batch, prompt_len, 2, device=dev,
                 params=params, prompts=prompts, enc_embed=enc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PlainMeter(kern) as plain:
        reset_launches(kern)                       # counts start here
        r = launch.serve(cfg, batch, prompt_len, new_tokens,
                         seed=0, device=dev, keep_logits=True)
        torch.cuda.synchronize()
        counted = read_launches(kern)              # and are read here
    peak = torch.cuda.max_memory_allocated()
    check_free(leg, peak)
    expected = expected_prefill_launches(cfg, prefills=1)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(r["params"]),
                                                tree_leaves(params)))
          and torch.equal(r["prompts"], prompts)
          and (enc is None or torch.equal(r["enc_embed"], enc)),
          f"{leg}: serve drew other weights, prompts or frame embeddings "
          f"from seed 0")
    check(counted["launches"] == expected,
          f"{leg}: launches {counted['launches']}, expected {expected} "
          f"for one prefill")
    check(counted["flash_routes"] == {"sm90": expected["flash"], "fma": 0},
          f"{leg}: flash launches by route {counted['flash_routes']}")
    windows = expected_flash_windows(cfg, prompt_len, 1)
    check(counted["flash_windows"] == windows, f"{leg}: flash launches by "
          f"window {counted['flash_windows']}, expected {windows}")
    check(not any(plain.calls.values()),
          f"{leg}: the serve path ran a plain version: {plain.calls}")
    total = prompt_len + new_tokens
    lens = attn_cache_lens(cfg, r["caches"])
    check(all(n == total for n in lens),
          f"{leg}: attention caches of {lens} slots, expected {total}")
    check(r["tokens"].shape == (batch, new_tokens)
          and bool(torch.isfinite(r["logits"]).all()),
          f"{leg}: tokens {tuple(r['tokens'].shape)} or non-finite logits")
    bf16_logits, bf16_tokens = r["logits"], r["tokens"]
    timings = {k: r[k] for k in ("prefill_s", "decode_s",
                                 "decode_tok_per_s")}
    cross_bytes = sum(a.numel() * a.element_size()
                      for a in cross_caches(r["caches"]))
    del r
    profile = profile_decode(launch, cfg, params, prompts, extra=extra)
    check(profile["cross_caches_unchanged"] is not False,
          f"{leg}: a decode step wrote the cross caches xk, xv")

    # float32 compute, the same weights and prompts
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                cache_dtype="float32")
    with RoutingMeter() as served:
        r32 = launch.serve(cfg32, batch, prompt_len, new_tokens,
                           device=dev, params=params, prompts=prompts,
                           enc_embed=enc, keep_logits=True)
    logits32, tokens32 = r32["logits"], r32["tokens"]
    check(all(n == total for n in attn_cache_lens(cfg32, r32["caches"])),
          f"{leg}: float32 caches did not grow by {new_tokens}")
    del r32
    full_tokens = torch.cat([prompts, tokens32[:, :-1].long()], dim=1)
    with torch.inference_mode(), RoutingMeter() as forced:
        h, _ = tfm.forward_hidden(params, {"tokens": full_tokens, **extra},
                                  cfg32, Runtime(), mode="prefill")
        # the positions whose logits the prefill and the decode steps gave:
        # (steps, B, V)
        full = unembed(params["embed"], h[:, prompt_len - 1:],
                       torch.float32, cfg32.final_softcap).transpose(0, 1)
        del h
        routed, kept = served_routed_alike(served, forced, cfg,
                                           *full_tokens.shape,
                                           logits32.device, prompt_len,
                                           new_tokens)
        alike = routed & kept
        err = (logits32 - full).abs().amax(-1)          # (steps, B)
        max_err = err[alike].max().item() if alike.any() else math.inf
        top2 = full.topk(2, dim=-1).values
        decided = alike & ((top2[..., 0] - top2[..., 1]) > 2 * max_err)
        agree = tokens32.transpose(0, 1).long() == full.argmax(-1)
        mismatched = int((decided & ~agree).sum())
        excluded = int((~decided).sum())
        routed_apart = int((~routed).sum())
        routed_apart_err = (err[~routed].max().item() if routed_apart
                            else None)
        dropped_apart = int((routed & ~kept).sum())
        dropped_apart_err = (err[routed & ~kept].max().item()
                             if dropped_apart else None)
        bf16_err = (bf16_logits - full).abs().max().item()
        bf16_token_agree = (bf16_tokens == tokens32).float().mean().item()
    del full, logits32, bf16_logits
    check(bool(alike.any()), f"{leg}: every step routed apart or dropped "
          f"by one run's capacity: nothing to compare")
    check(max_err <= SERVE_LOGIT_TOL,
          f"{leg}: float32 prefill/decode logits differ from the full "
          f"forward by {max_err} (bound {SERVE_LOGIT_TOL}) on the steps "
          f"routed alike and kept in both runs ({routed_apart} routed "
          f"apart, {dropped_apart} with a choice one run's capacity "
          f"dropped)")
    check(mismatched == 0, f"{leg}: {mismatched} greedy tokens differ from "
          f"the full forward's argmax where its top-2 gap exceeds "
          f"{2 * max_err}")
    # a decode step reads every decoder weight once (the input embedding
    # only for the batch's rows): float32 masters over the card's memory
    # rate; and the cross caches, where there are some
    encoder_params = sum(p.numel() for p in tree_leaves(
        params.get("encoder", {})))
    weight_bytes = 4 * (n_params - encoder_params
                        - (0 if cfg.tie_embeddings
                           else cfg.vocab_size * cfg.d_model))
    decode_ms = 1e3 * timings["decode_s"] / (new_tokens - 1)
    record = dict(
        phase=phase, leg=leg, model=cfg.name,
        layers=[spec.kind for spec in cfg.layer_specs()],
        compute_dtype=cfg.compute_dtype, n_params=n_params,
        batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
        prefill_ms=1e3 * timings["prefill_s"],
        decode_ms_per_token=decode_ms,
        decode_tokens_per_s=timings["decode_tok_per_s"],
        decode_weight_bytes=weight_bytes, decode_cross_cache_bytes=cross_bytes,
        decode_weight_read_bound_ms=(weight_bytes + cross_bytes)
        / HBM_BYTES_PER_S * 1e3,
        peak_bytes=peak, cache_lens=sorted(set(lens)),
        float32_max_abs_err=max_err, float32_bound=SERVE_LOGIT_TOL,
        float32_steps_compared=new_tokens * batch,
        float32_steps_excluded=excluded,
        float32_steps_routed_apart=routed_apart,
        float32_routed_apart_max_abs_err=routed_apart_err,
        float32_steps_compared_alike=int(alike.sum()),
        float32_steps_dropped_in_one_run=dropped_apart,
        float32_dropped_in_one_run_max_abs_err=dropped_apart_err,
        float32_dropped_choices={"serve": served.dropped_total(),
                                 "full_forward": forced.dropped_total()},
        bfloat16_max_abs_err_vs_float32_forward=bf16_err,
        bfloat16_token_agreement_with_float32=bf16_token_agree,
        plain_calls=plain.calls, leg_s=time.perf_counter() - t_leg,
        decode_profile=profile, **counted)
    emit(**record)
    del params
    return record


def served_routed_alike(served, forced, cfg, B: int, S: int, device,
                        prompt_len: int = SERVE_PROMPT,
                        new_tokens: int = SERVE_NEW):
    """Two (steps, B) bool masks over a serve run's steps: the tokens that
    every MoE layer routed as the teacher-forced full forward did, and
    those that kept all their choices in both runs (all steps for a model
    without MoE layers).  A token the capacity drops in one run and not in
    the other (groups of 512 tokens in a prefill or full forward, of B
    tokens in a decode step) has another function of its input there, as
    in the reference.  ``served`` recorded the prefill (one call a MoE
    layer), then each decode step (one call a layer); ``forced`` the full
    forward.  Step 0's logits come from the prompt's last position, step
    i's from position prompt_len - 1 + i."""
    import torch
    n = moe_layers(cfg)
    if not n:
        every = torch.ones((new_tokens, B), dtype=torch.bool, device=device)
        return every, every

    def steps(record):
        prompt = served.tokens(range(n), B, prompt_len, record)[:, :, -1:]
        decode = [served.tokens(range(n + i * n, 2 * n + i * n), B, 1,
                                record) for i in range(new_tokens - 1)]
        return torch.cat([prompt] + decode, dim=2)     # (n, B, steps, k)

    def forced_steps(record):
        return forced.tokens(range(n), B, S, record)[:, :, prompt_len - 1:]

    alike = (steps(None) == forced_steps(None)).all(-1).all(0)
    kept = (steps(served.kept).all(-1).all(0)
            & forced_steps(forced.kept).all(-1).all(0))
    return alike.transpose(0, 1), kept.transpose(0, 1)


def profile_decode(launch, cfg, params, prompts, steps: int = 8,
                   extra=None) -> dict:
    """``steps`` decode steps after a prefill of ``prompts`` (and the
    batch's ``extra`` entries) under torch.profiler (after as many that
    let it start up): the device's busy time a token against the host's,
    and the device kernels that took the most time; with cross caches,
    whether they are bit-equal after the steps to the prefill's.  Outside
    the counted run."""
    import torch
    prefill, decode = launch.make_serving_fns(cfg)
    last, caches = prefill(params, {"tokens": prompts, **(extra or {})})
    caches = launch.extend_caches(caches, cfg, steps)
    before = [a.clone() for a in cross_caches(caches)]
    tok = last.argmax(-1).to(torch.int32)[:, None]

    def run():
        t = tok
        for i in range(steps):      # the same slots, rewritten each run
            t, _, _ = decode(params, t, caches, prompts.shape[1] + i)
            t = t[:, None]
        torch.cuda.synchronize()

    traced, wall = profiled(run)
    busy_us, spans, top = device_busy(traced)
    after = cross_caches(caches)
    unchanged = (all(torch.equal(a, b) for a, b in zip(before, after))
                 if before else None)
    return {"steps": steps, "wall_ms_per_token": 1e3 * wall / steps,
            "cross_caches_unchanged": unchanged,
            "device_busy_ms_per_token": busy_us / 1e3 / steps,
            "device_idle_share": (1.0 - busy_us / 1e6 / wall
                                  if spans else None),
            "device_kernels_per_token": len(spans) / steps,
            "top_device_ms_per_token": [[k[:90], ms / steps, n / steps]
                                        for k, ms, n in top[:8]]}


def phase_serve_path(kern, dev) -> dict:
    """The serve launcher's three legs: internlm2 (4 layers), the Jamba
    cut (Mamba and attention) and xlstm-125m, each at full width."""
    t0 = time.perf_counter()
    legs = {"serve_lm": serve_leg(kern, dev, "serve_lm", lm_config(),
                                  630_736_896),
            "serve_hybrid": serve_leg(kern, dev, "serve_hybrid",
                                      hybrid_config(), HYBRID_PARAMS),
            "serve_xlstm": serve_leg(kern, dev, "serve_xlstm",
                                     xlstm_config(), XLSTM_PARAMS)}
    emit(phase="serve_path_done", seconds=time.perf_counter() - t0)
    return legs


def serving_leg(kern, dev, leg: str, make_world, serving_kw: dict,
                sim_time: float) -> dict:
    """``DagAflCoordinator`` with serving on over a world that
    ``make_world()`` builds afresh ((backend, client data, test set,
    DagAflConfig keywords, genesis)), cadence a quarter of the path's
    ``sim_time`` and SERVING_QUERIES expected queries over it, with the
    launch counts set to 0 just before and read just after; every replica
    checked against a fresh Eq. 6 over its refs as it is published.  The
    same world without serving runs before it (its tx ids and hashes are
    compared, a reading), and again when they differ."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.fl import serving as srv

    def ledger_of(coord):
        """(tx ids with their parents, the Eq. 7 hashes)."""
        txs = list(coord.ledger.transactions())
        return ([(t.tx_id, t.parents) for t in txs],
                [coord.ledger.hash_of(t.tx_id) for t in txs])

    forwards = {"evaluate": 0, "signature": 0}

    def run(serving=None):
        gc.collect()
        torch.cuda.empty_cache()
        backend, data, test, kw, genesis = make_world()
        for name in forwards:                  # one forward a call
            def counted(*a, _fn=getattr(backend, name), _name=name, **k):
                forwards[_name] += 1
                return _fn(*a, **k)
            setattr(backend, name, counted)
        coord = DagAflCoordinator(backend, data, test,
                                  DagAflConfig(serving=serving, **kw))
        return coord, coord.run(init_model=genesis)

    off, _ = run()
    off_ledger = ledger_of(off)
    del off
    scfg = srv.ServingConfig(every=sim_time / 4,
                             query_rate=SERVING_QUERIES / sim_time,
                             query_batch=8, **serving_kw)
    parity = []
    inner = srv.ConsensusPublisher.publish

    def checked_publish(pub):
        rep = inner(pub)
        if rep is not None:
            parity.append(srv.replica_parity(rep, pub.store))
        return rep

    srv.ConsensusPublisher.publish = checked_publish
    try:
        with PlainMeter(kern) as plain:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(kern)                   # counts start here
            forwards.update(evaluate=0, signature=0)
            t0 = time.perf_counter()
            coord, result = run(scfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counted = read_launches(kern)          # and are read here
    finally:
        srv.ConsensusPublisher.publish = inner
    peak = torch.cuda.max_memory_allocated()
    serving = result.extra["serving"]
    ok, why = verify_full_dag(coord.ledger)
    rounds = result.rounds
    check(serving["replica_versions"] >= 3 and serving["queries"] >= 8,
          f"{leg}: {serving['replica_versions']} replica versions and "
          f"{serving['queries']} queries (at least 3 and 8)")
    check(serving["skipped"] == 0, f"{leg}: {serving['skipped']} queries "
          f"skipped (v0 is published at genesis)")
    check(sum(serving["replica_version_hist"].values())
          == serving["queries"], f"{leg}: version histogram "
          f"{serving['replica_version_hist']} against "
          f"{serving['queries']} queries")
    check(len(parity) == serving["replica_versions"] and all(parity),
          f"{leg}: replica parity {parity}")
    check(result.extra["chain_len"] == 1 + rounds,
          f"{leg}: chain_len {result.extra['chain_len']} != 1 + {rounds}")
    check(ok, f"{leg}: verify_full_dag: {why}")
    check(not any(plain.calls.values()),
          f"{leg}: the path ran a plain version: {plain.calls}")
    driver = coord.query_stream.driver
    lm = isinstance(driver, srv.LMQueryDriver)
    # a CNN query is an evaluation without kernels; an LM query one
    # prefill, and the LM backend's every call one forward on the kernels
    if lm:
        expected = expected_prefill_launches(
            coord.backend.cfg, prefills=serving["queries"],
            signatures=forwards["signature"],
            forwards=forwards["evaluate"] + forwards["signature"])
    else:
        expected = {"signature": forwards["signature"], "flash": 0,
                    "scan": 0, "mlstm": 0, "slstm": 0}
    check(counted["launches"] == expected,
          f"{leg}: launches {counted['launches']}, expected {expected} for "
          f"{forwards} backend calls and {serving['queries']} queries")
    check(counted["flash_routes"]["fma"] == 0
          and counted["signature_routes"]["strided"] == 0,
          f"{leg}: launches by route {counted['flash_routes']}, "
          f"{counted['signature_routes']}")
    record = dict(phase="serving_path", leg=leg, rounds=rounds,
                  chain_len=result.extra["chain_len"],
                  sim_time=result.sim_time, cadence=scfg.every,
                  query_rate=scfg.query_rate, wall_s=wall,
                  peak_bytes=peak, serving=serving,
                  replica_parity=parity, verify_full_dag=why,
                  backend_calls=dict(forwards), **counted)
    if lm:
        rep = coord.publisher.replica()
        prompts = np.random.default_rng(5).integers(
            0, driver.cfg.vocab_size, (driver.batch, driver.prompt_len))
        got = driver.decode_prompts(rep.params, prompts)
        want = driver.decode_prompts(
            srv.consensus_over_refs(coord.store, rep.model_refs), prompts)
        check(np.array_equal(got, want), f"{leg}: the last replica's tokens "
              f"differ from those of Eq. 6 over its refs")
        record["replica_tokens_equal_direct_eq6"] = True
    on_ledger = ledger_of(coord)
    record["tx_ids_equal_without_serving"] = on_ledger[0] == off_ledger[0]
    record["hashes_equal_without_serving"] = on_ledger[1] == off_ledger[1]
    del coord, driver
    if on_ledger != off_ledger:
        # card nondeterminism or serving: the serving-off world twice
        again, _ = run()
        twice = ledger_of(again)
        record["tx_ids_equal_off_twice"] = twice[0] == off_ledger[0]
        record["hashes_equal_off_twice"] = twice[1] == off_ledger[1]
        del again
    emit(**record)
    return record


def phase_serving_path(kern, dev, cnn_sim_time: float,
                       lm_sim_time: float) -> dict:
    """Serving on the coordinator over the CNN path's world (VGG16, 4
    clients, 2 rounds) and the LM path's (internlm2 full width, 4 layers,
    4 clients, 2 rounds of 8 local steps)."""
    import torch
    from repro_torch.fl.backend import CNNBackend, LMBackend
    t0 = time.perf_counter()

    def cnn():
        cfg, client_data, test, _ = cnn_world()
        backend = CNNBackend(cfg, local_epochs=1, batch_size=64)
        genesis = backend.init(torch.Generator().manual_seed(0))
        return (backend, client_data, test,
                dict(n_clients=4, max_rounds=2, local_epochs=1), genesis)

    def lm():
        streams, global_test = lm_streams(4)
        backend = LMBackend(lm_config(), lr=3e-3, local_steps=8,
                            batch_size=8, seq_len=512)
        genesis = backend.init(torch.Generator(device=dev).manual_seed(0))
        data = [{"train": s, "val": s, "test": s} for s in streams]
        return (backend, data, global_test,
                dict(n_clients=4, max_rounds=2, local_epochs=2), genesis)

    legs = {"cnn_serving": serving_leg(kern, dev, "serving_cnn", cnn, {},
                                       cnn_sim_time),
            "lm_serving": serving_leg(
                kern, dev, "serving_lm", lm,
                dict(prompt_len=512, new_tokens=16, seed=1234),
                lm_sim_time)}
    emit(phase="serving_path_done", seconds=time.perf_counter() - t0)
    return legs


def moe_forward_check(tfm, cfg, backend, params, stream, compute: str,
                      checked: bool, leg: str = "moe_backend") -> dict:
    """The kernel forward (flash attention, the selective scan) against
    the plain forward (dense attention, the model's chunked scan) of
    ``params`` in ``mode="prefill"``, the backend's tip-selection
    forwards, on one batch of ``stream`` with the products in
    ``compute``.  A token the two forwards route to other experts is a
    near-tie of the router, not an error: the share of tokens routed
    alike is held at MOE_ROUTED_ALIKE_MIN and the logits within
    SERVE_LOGIT_TOL (the reference's 2e-2) on those tokens, when
    ``checked``; the tokens each forward dropped are reported."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.runtime import Runtime
    c = dataclasses.replace(cfg, compute_dtype=compute)
    batch = backend._batch(backend._sample(stream, np.random.default_rng(3),
                                           1)[0])
    B, S = batch["tokens"].shape
    runs = {}
    for name, kernels in (("kernel", True), ("plain", False)):
        with torch.inference_mode(), RoutingMeter() as routes:
            logits, aux = tfm.forward(params, batch, c, Runtime(
                use_kernels=kernels, want_signature=True), mode="prefill")
        runs[name] = (logits, aux["signature"], routes)
    (k_logits, k_sig, k_routes), (p_logits, p_sig, p_routes) = \
        runs["kernel"], runs["plain"]
    n = moe_layers(cfg)
    alike = (k_routes.tokens(range(n), B, S) == p_routes.tokens(
        range(n), B, S)).all(-1).all(0)                  # (B, S)
    share = alike.float().mean().item()
    with torch.inference_mode():
        err = (k_logits - p_logits).abs().amax(-1)       # (B, S)
        logit_err = err[alike].max().item()
        apart_err = err[~alike].max().item() if not alike.all() else None
        scale = p_logits.abs().max().item()
        argmax_agree = (k_logits.argmax(-1) == p_logits.argmax(-1)
                        ).float().mean().item()
        sig_err = (k_sig - p_sig).abs().max().item()
    check(bool(torch.isfinite(k_logits).all()), f"non-finite MoE logits "
          f"({compute})")
    if checked:
        check(share >= MOE_ROUTED_ALIKE_MIN, f"{leg}: {share} of the "
              f"tokens routed alike by the kernel and plain forwards "
              f"({compute}), below {MOE_ROUTED_ALIKE_MIN}")
        check(logit_err <= SERVE_LOGIT_TOL, f"{leg}: kernel logits "
              f"differ from the plain forward's by {logit_err} on the "
              f"tokens routed alike ({compute})")
        check(sig_err <= LM_SIG_TOL, f"{leg}: kernel signature "
              f"differs from plain by {sig_err} ({compute})")
    return {"compute_dtype": compute, "checked": checked,
            "routed_alike_share": share,
            "tokens_routed_apart": int((~alike).sum()),
            "logits_max_abs_err_routed_alike": logit_err,
            "logits_max_abs_err_routed_apart": apart_err,
            "logits_scale": scale, "argmax_agreement": argmax_agree,
            "signature_max_abs_err": sig_err,
            "dropped_choices": {"kernel": k_routes.dropped_total(),
                                "plain": p_routes.dropped_total()},
            "routed_choices": routed_choices(cfg, B * S)}


def backend_calls(kern, leg: str, cfg, backend, params, streams) -> tuple:
    """``LMBackend.evaluate`` and ``signature`` once a stream (the
    tip-selection forwards, ``mode="prefill"``), after one warm-up call of
    each, with the launch counts set to 0 just before and read just after:
    one launch a layer of each kernel's kind a forward, all flash on sm90,
    one signature launch a signature call on vec, no plain call; the
    accuracies and signatures in range.  Returns (counts, seconds by
    call, accuracies, peak bytes, plain calls)."""
    import numpy as np
    import torch
    backend.evaluate(params, streams[0])       # warm-up, outside the count
    backend.signature(params, streams[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = {"evaluate": [], "signature": []}
    accs, sigs = [], []
    with PlainMeter(kern) as plain:
        reset_launches(kern)                       # counts start here
        for stream in streams:
            t0 = time.perf_counter()
            accs.append(backend.evaluate(params, stream))
            seconds["evaluate"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            sigs.append(backend.signature(params, stream))
            seconds["signature"].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        counted = read_launches(kern)              # and are read here
    peak = torch.cuda.max_memory_allocated()
    check_free(leg, peak)
    calls = len(streams)
    expected = expected_prefill_launches(cfg, prefills=0, signatures=calls,
                                         forwards=2 * calls)
    check(counted["launches"] == expected, f"{leg}: launches "
          f"{counted['launches']}, expected {expected} for {calls} evaluate "
          f"and {calls} signature calls")
    check(counted["flash_routes"] == {"sm90": expected["flash"], "fma": 0},
          f"{leg}: flash launches by route {counted['flash_routes']}")
    windows = expected_flash_windows(cfg, backend.seq_len, 2 * calls)
    check(counted["flash_windows"] == windows, f"{leg}: flash launches by "
          f"window {counted['flash_windows']}, expected {windows}")
    check(counted["signature_routes"] == {"vec": calls, "strided": 0},
          f"{leg}: signature launches by route "
          f"{counted['signature_routes']}")
    check(not any(plain.calls.values()),
          f"{leg}: the path ran a plain version: {plain.calls}")
    check(all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs)
          and all(s.shape == (64,) and np.all((s >= 0) & (s <= 1))
                  for s in sigs), f"{leg}: accuracies {accs} or "
          f"signatures out of range")
    seconds = {k: [1e3 * t for t in v] for k, v in seconds.items()}
    return counted, seconds, accs, peak, plain.calls


def moe_backend_leg(kern, dev, cfg, leg: str = "moe_backend",
                    phase: str = "moe_path",
                    expected_params: int = MOE_PARAMS) -> dict:
    """``LMBackend.evaluate`` and ``signature`` (the tip-selection forwards,
    ``mode="prefill"``) on one full-width MoE model at batch 8 x 512, with
    the launch counts set to 0 just before and read just after (one flash
    and one scan launch a forward, all flash on sm90; one signature launch
    a signature call, on the vec route; no plain call); then the kernel
    forward against the plain forward in float32 (checked) and bfloat16
    (reported)."""
    import gc

    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.fl.backend import LMBackend
    from repro_torch.models import transformer as tfm

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    streams, global_test = lm_streams(2)
    backend = LMBackend(cfg, lr=3e-3, local_steps=2, batch_size=8,
                        seq_len=512)
    check(backend.device.type == "cuda", f"{leg}: backend is not on the "
          f"card")
    t0 = time.perf_counter()
    params = backend.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == tree_param_count(cfg) == expected_params,
          f"{leg}: {n_params} parameters, expected {expected_params}")
    counted, seconds, accs, peak, plain_calls = backend_calls(
        kern, leg, cfg, backend, params, streams)
    checks = {c: moe_forward_check(tfm, cfg, backend, params, global_test,
                                   c, checked=c == "float32", leg=leg)
              for c in ("float32", "bfloat16")}
    record = dict(
        phase=phase, leg=leg, model=cfg.name,
        layers=[[spec.kind, spec.ffn] for spec in cfg.layer_specs()],
        experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        d_expert=cfg.moe.d_expert, n_params=n_params, batch=8, seq_len=512,
        data_vocab=LM_DATA_VOCAB, init_s=init_s,
        evaluate_ms=seconds["evaluate"], signature_ms=seconds["signature"],
        accuracies=accs, peak_bytes=peak, plain_calls=plain_calls,
        forward_check=checks, leg_s=time.perf_counter() - t_leg, **counted)
    emit(**record)
    del params, backend
    return record


def moe_train_leg(kern, dev, cfg, leg: str = "moe_train",
                  phase: str = "moe_path", batch: int = 8, seq: int = 512,
                  expected_params=None, enc_embed=None) -> dict:
    """``launch/train.train_single`` on a full-width cut: TRAIN_STEPS AdamW
    steps with the config's moments (Jamba's and deepseek-v2's bfloat16;
    clip 1.0, the signature in the metrics) over a TokenPipeline of the LM
    paths' sub-vocabulary, by default batch 8 x 512 (a config with an
    encoder gets ``enc_embed``, else the launcher's zero frames), with the
    launch
    counts set to 0 just before and read just after: the last 3 steps'
    mean loss below step 0's, one signature launch a step and no other
    kernel, and the peak leaving MOE_FREE_BYTES_MIN of the card free; with
    MoE layers, a finite ``moe_aux`` above 0 at every step and the choices
    the capacity dropped; with ``expected_params``, the trained tree's
    count and no allocator retry in the run."""
    import argparse
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch
    from repro_torch.runtime import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    pipe = TokenPipeline(LM_DATA_VOCAB, batch, seq, seed=0)
    args = argparse.Namespace(steps=TRAIN_STEPS, batch=batch, seq=seq,
                              seed=0, device=str(dev),
                              log_every=TRAIN_STEPS, checkpoint="")
    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    with PlainMeter(kern) as plain, RoutingMeter() as routes:
        reset_launches(kern)                       # counts start here
        t0 = time.perf_counter()
        params = launch.train_single(cfg, args, pipe=pipe, history=history,
                                     enc_embed=enc_embed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = read_launches(kern)              # and are read here
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    n_params = sum(p.numel() for p in tree_leaves(params))
    del params
    if expected_params is not None:
        check(n_params == tree_param_count(cfg) == expected_params,
              f"{leg}: {n_params} parameters, expected {expected_params}")
        check(retries == 0, f"{leg}: {retries} allocator retries")
    losses = [h["loss"] for h in history]
    aux = [h["moe_aux"] for h in history]
    n = moe_layers(cfg)
    # a step routes each MoE layer in its forward, and with remat again in
    # its period's recompute, which must route and drop as the forward did
    remat = Runtime().remat
    per_step = (2 if remat else 1) * n
    steps_routed = [(routes.choices[i * per_step:i * per_step + n],
                     routes.dropped[i * per_step:i * per_step + n],
                     routes.choices[i * per_step + n:(i + 1) * per_step],
                     routes.dropped[i * per_step + n:(i + 1) * per_step])
                    for i in range(len(history))]
    dropped = [sum(int(d) for d in fwd_dropped)
               for _, fwd_dropped, _, _ in steps_routed]
    replayed_alike = [all(any(torch.equal(a, b) and int(da) == int(db)
                              for b, db in zip(rep_c, rep_d))
                          for a, da in zip(fwd_c, fwd_d))
                      for fwd_c, fwd_d, rep_c, rep_d in steps_routed]
    check(len(history) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"{leg}: losses {losses}")
    if n:
        check(all(np.isfinite(a) and a > 0 for a in aux),
              f"{leg}: moe_aux {aux}")
    else:
        check(all(a == 0.0 for a in aux), f"{leg}: moe_aux {aux} without "
              f"MoE layers")
    check(float(np.mean(losses[-3:])) < losses[0], f"{leg}: the mean "
          f"loss of the last 3 steps {np.mean(losses[-3:])} is not below "
          f"step 0's {losses[0]}")
    expected = {"signature": TRAIN_STEPS, "flash": 0, "scan": 0, "mlstm": 0,
                "slstm": 0}
    check(counted["launches"] == expected and not any(plain.calls.values()),
          f"{leg}: launches {counted['launches']} (plain {plain.calls})"
          f": one signature launch a step and nothing else")
    check(counted["signature_routes"] == {"vec": TRAIN_STEPS, "strided": 0},
          f"{leg}: signature launches by route "
          f"{counted['signature_routes']}")
    check(len(routes.dropped) == per_step * TRAIN_STEPS, f"{leg}: "
          f"{len(routes.dropped)} routings for {TRAIN_STEPS} steps, "
          f"expected {per_step} a step")
    check(all(replayed_alike), f"{leg}: the recompute routed or dropped "
          f"otherwise than the forward at steps {replayed_alike}")
    total = check_free(leg, peak)
    step_s = [h["seconds"] for h in history]
    ms = 1e3 * float(np.mean(step_s[1:]))
    record = dict(
        phase=phase, leg=leg, model=cfg.name, optimizer="adamw",
        remat=remat, frames=None if cfg.encoder is None else (
            "zeros" if enc_embed is None else "given"),
        moment_dtype=cfg.moment_dtype, clip_norm=1.0, batch=batch,
        seq_len=seq, microbatches=1, data_vocab=LM_DATA_VOCAB,
        steps=TRAIN_STEPS, n_params=n_params, losses=losses, moe_aux=aux,
        grad_norms=[h["grad_norm"] for h in history],
        step_ms=[1e3 * t for t in step_s], ms_per_step=ms,
        tokens_per_s=batch * seq / (ms / 1e3), wall_s=wall, peak_bytes=peak,
        peak_reserved_bytes=reserved, card_bytes=total,
        alloc_retries=retries,
        plain_calls=plain.calls, leg_s=time.perf_counter() - t_leg,
        **counted)
    if n:
        record.update(dropped_choices=dropped,
                      routed_choices_per_step=routed_choices(cfg,
                                                             batch * seq))
    emit(**record)
    return record


def phase_moe_path(kern, dev) -> dict:
    """The MoE cut (``hybrid_moe_config``) at full Jamba width: the
    backend's tip-selection forwards, the trainer and the serve launcher."""
    t0 = time.perf_counter()
    cfg = hybrid_moe_config()
    legs = {"moe_backend": moe_backend_leg(kern, dev, cfg),
            "moe_train": moe_train_leg(kern, dev, cfg),
            "moe_serve": serve_leg(kern, dev, "moe_serve", cfg, MOE_PARAMS)}
    emit(phase="moe_path_done", seconds=time.perf_counter() - t0)
    return legs


class ScoreMeter:
    """Counts, while entered, the calls of the attention module's plain
    score paths (banded, chunked, dense) and of the loss's cross-entropy
    chunks, and the head dims and windows of the flash launches that the
    models ask for; restores every function on exit."""
    PATHS = ("_banded_attn", "_chunked_attn", "_dense_attn")

    def __enter__(self):
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as tfm
        self.mods = [(A, name) for name in self.PATHS] + [(tfm, "_ce_part")]
        self.calls = {name: 0 for _, name in self.mods}
        self.flash = []
        self.inner = {name: getattr(mod, name) for mod, name in self.mods}
        for mod, name in self.mods:
            def counted(*a, _fn=self.inner[name], _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        self.ops, self.flash_fn = A.ops, A.ops.flash_attention

        def flash(q, k, v, **kw):
            self.flash.append((q.shape[-1], kw.get("window", -1)))
            return self.flash_fn(q, k, v, **kw)
        A.ops.flash_attention = flash
        return self

    def __exit__(self, *exc):
        for mod, name in self.mods:
            setattr(mod, name, self.inner[name])
        self.ops.flash_attention = self.flash_fn


def chunked_logit_err(params, cfg, h_a, h_b, rows: int = 1024) -> float:
    """The largest |logit| difference of two hidden states (B, S, d),
    unembedded ``rows`` positions at a time: the whole (B, S, V) float32
    logits of gemma3-27b at 2 x 8,192 take 17 GB."""
    from repro_torch.models.layers import torch_dtype, unembed
    err = 0.0
    for i in range(0, h_a.shape[1], rows):
        la, lb = (unembed(params["embed"], h[:, i:i + rows],
                          torch_dtype(cfg.compute_dtype), cfg.final_softcap)
                  for h in (h_a, h_b))
        err = max(err, (la - lb).abs().max().item())
    return err


def long_forward_check(tfm, cfg, params, tokens, compute: str,
                       checked: bool, leg: str) -> dict:
    """The kernel forward (flash attention at any length) against the
    plain forward of ``params`` (past 2,048 tokens: the banded path for the
    local layers and the chunked path for the global ones; else the dense
    scores) on ``tokens``
    with the products in ``compute``: logits within SERVE_LOGIT_TOL (the
    reference's 2e-2) and the signature within LM_SIG_TOL, when
    ``checked``."""
    import dataclasses

    import torch
    from repro_torch.models.attention import _DENSE_MAX
    from repro_torch.runtime import Runtime
    c = dataclasses.replace(cfg, compute_dtype=compute)
    runs = {}
    for name, kernels in (("kernel", True), ("plain", False)):
        with torch.inference_mode(), ScoreMeter() as meter:
            h, aux = tfm.forward_hidden(params, {"tokens": tokens}, c,
                                        Runtime(use_kernels=kernels,
                                                want_signature=True),
                                        mode="prefill")
        runs[name] = (h, aux["signature"], meter.calls)
    (kh, k_sig, k_calls), (ph, p_sig, p_calls) = runs["kernel"], runs["plain"]
    with torch.inference_mode():
        logit_err = chunked_logit_err(params, c, kh, ph)
        sig_err = (k_sig - p_sig).abs().max().item()
    S = tokens.shape[1]
    windows = [tfm.resolve_window(cfg, spec, S)
               for spec in cfg.layer_specs() if spec.kind == "attn"]
    if S > _DENSE_MAX:
        want = {"_banded_attn": sum(w > 0 for w in windows),
                "_chunked_attn": sum(w <= 0 for w in windows),
                "_dense_attn": 0}
    else:                              # up to 2,048 tokens: the scores
        want = {"_banded_attn": 0, "_chunked_attn": 0,
                "_dense_attn": len(windows)}
    check(all(k_calls[n] == 0 for n in want) and all(
        p_calls[n] == want[n] for n in want), f"{leg}: score paths "
          f"{p_calls} of the plain forward, {k_calls} of the kernel "
          f"forward, expected {want} and none")
    check(bool(torch.isfinite(kh).all()), f"{leg}: non-finite hidden "
          f"states ({compute})")
    if checked:
        check(logit_err <= SERVE_LOGIT_TOL, f"{leg}: kernel logits differ "
              f"from the plain forward's by {logit_err} ({compute})")
        check(sig_err <= LM_SIG_TOL, f"{leg}: kernel signature differs "
              f"from plain by {sig_err} ({compute})")
    del runs, kh, ph
    return {"compute_dtype": compute, "checked": checked,
            "logits_max_abs_err": logit_err, "signature_max_abs_err": sig_err,
            "plain_score_paths": {k[1:]: v for k, v in p_calls.items()}}


def gemma3_backend_leg(kern, dev) -> list:
    """gemma3-27b, one published period (5 local layers of window 1,024,
    then one global) at full width: ``LMBackend.evaluate`` and
    ``signature`` at batch 2 x 8,192 (flash 6 times a forward on sm90,
    the local layers' kv loops from the window's first live tile), the
    kernel forward against the plain forward (banded and chunked) in
    float32 (checked) and bfloat16 (reported); then, after one warm-up
    step, 2 steps of ``train_local`` at batch 1 x GEMMA3_TRAIN_SEQ
    through the banded and chunked paths and the chunked cross-entropy
    under autograd: the mean loss below the start's, no allocator retry.
    Returns the backend and training records."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.fl.backend import LMBackend
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    cfg = gemma3_config()
    streams, global_test = lm_streams(2)
    backend = LMBackend(cfg, lr=3e-3, local_steps=2,
                        batch_size=GEMMA3_BATCH, seq_len=GEMMA3_SEQ)
    check(backend.device.type == "cuda", "gemma3_backend: backend is not "
          "on the card")
    gen = torch.Generator(device=dev)
    params = backend.init(gen.manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == tree_param_count(cfg) == GEMMA3_PARAMS,
          f"gemma3_backend: {n_params} parameters, expected {GEMMA3_PARAMS}")
    with ScoreMeter() as shapes:
        counted, seconds, accs, peak, plain_calls = backend_calls(
            kern, "gemma3_backend", cfg, backend, params, streams)
    windows = sorted(set(shapes.flash))
    check(windows == [(cfg.head_dim, -1), (cfg.head_dim, 1024)],
          f"gemma3_backend: flash asked for (head_dim, window) {windows}")
    tokens = backend._batch(backend._sample(
        global_test, np.random.default_rng(3), 1)[0])["tokens"]
    checks = {c: long_forward_check(tfm, cfg, params, tokens, c,
                                    checked=c == "float32",
                                    leg="gemma3_backend")
              for c in ("float32", "bfloat16")}
    tokens_per_s = GEMMA3_BATCH * GEMMA3_SEQ / (
        np.mean(seconds["evaluate"]) / 1e3)
    record = dict(
        phase="attention_variants_path", leg="gemma3_backend",
        model=cfg.name, windows=[s.window for s in cfg.layer_specs()],
        n_params=n_params, batch=GEMMA3_BATCH, seq_len=GEMMA3_SEQ,
        data_vocab=LM_DATA_VOCAB, evaluate_ms=seconds["evaluate"],
        signature_ms=seconds["signature"],
        evaluate_tokens_per_s=tokens_per_s, accuracies=accs,
        peak_bytes=peak, plain_calls=plain_calls, forward_check=checks,
        leg_s=time.perf_counter() - t_leg, **counted)
    emit(**record)

    # local training: the caller's tree goes in and is dropped, so that
    # train_local's copy, its gradients and SGD's momentum (3 x 15.55 GB)
    # are what the card holds.  One step first, outside the count, from
    # the fresh weights: first use of the backward's kernels and the
    # allocator's pools at this peak; then 2 steps from its result, with
    # the counts set to 0 just before and read just after
    seq, steps = GEMMA3_TRAIN_SEQ, 2
    learner = LMBackend(cfg, lr=3e-3, local_steps=steps, batch_size=1,
                        seq_len=seq)
    held = [params]
    del params

    def run(epochs: int):
        """train_local from the held tree, which it consumes: (loss, s,
        the allocator's retries after a failed cudaMalloc, each of which
        frees the cache and synchronises the card)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        trained, loss = learner.train_local(held.pop(), streams[0],
                                            epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        held.append(trained)
        return loss, wall, torch.cuda.memory_stats().get(
            "num_alloc_retries", 0) - retries

    torch.cuda.reset_peak_memory_stats()
    warm_loss, warm_s, warm_retries = run(1)
    with torch.no_grad():              # the loss of train_local's 1st batch
        first = learner._batch(learner._sample(
            streams[0], np.random.default_rng(0), steps)[0])
        initial_loss = float(tfm.loss_fn(held[0], first, cfg)[0])
        del first
    with PlainMeter(kern) as plain, ScoreMeter() as meter:
        reset_launches(kern)                       # counts start here
        loss, wall, retries = run(None)
        train_counted = read_launches(kern)        # and are read here
    train_peak = torch.cuda.max_memory_allocated()
    held.clear()
    total = check_free("gemma3_train", train_peak)
    layers = cfg.layer_specs()
    # each period's forward, and again in its checkpoint's backward
    # (``Runtime.remat``, on in ``train_local``)
    passes = 2 if Runtime().remat else 1
    want = {"_banded_attn": passes * steps * sum(s.window > 0
                                                 for s in layers),
            "_chunked_attn": passes * steps * sum(s.window <= 0
                                                  for s in layers),
            "_dense_attn": 0,
            # each chunk's forward, and again in its checkpoint's backward
            "_ce_part": steps * 2 * (seq // tfm._ce_chunk(cfg, 1, seq))}
    check(meter.calls == want, f"gemma3_train: score paths and CE chunks "
          f"{meter.calls}, expected {want}")
    check(not any(train_counted["launches"].values())
          and not any(plain.calls.values()), f"gemma3_train: launches "
          f"{train_counted['launches']} (plain {plain.calls}): training "
          f"runs no kernel")
    check(np.isfinite(loss) and loss < initial_loss, f"gemma3_train: mean "
          f"loss {loss} of {steps} steps, from {initial_loss} at the start")
    check(retries == 0, f"gemma3_train: {retries} allocator retries in the "
          f"counted steps: their time would measure the allocator")
    train_record = dict(
        phase="attention_variants_path", leg="gemma3_train", model=cfg.name,
        optimizer="sgd", momentum=0.9, remat=Runtime().remat, batch=1,
        seq_len=seq, steps=steps,
        mean_loss=loss, initial_loss=initial_loss, warmup_loss=warm_loss,
        warmup_ms=1e3 * warm_s, warmup_alloc_retries=warm_retries,
        ms_per_step=1e3 * wall / steps, tokens_per_s=steps * seq / wall,
        peak_bytes=train_peak, card_bytes=total, alloc_retries=retries,
        score_path_calls={k[1:]: v for k, v in meter.calls.items()},
        plain_calls=plain.calls, **train_counted)
    emit(**train_record)
    del backend
    return [record, train_record]


def mrope_positions(B: int, device):
    """(3, B, 512) M-RoPE ids of MROPE_LAYOUT: text 0..63, the 16 x 24
    grid at (t, h, w) = (64, 64 + row, 64 + col), then text from the
    grid's largest id + 1 (88) on."""
    import torch
    text, rows, cols, tail = MROPE_LAYOUT
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                          indexing="ij")
    head = torch.arange(text)[None].expand(3, text)
    grid = torch.stack([torch.full((rows * cols,), text),
                        text + r.reshape(-1), text + c.reshape(-1)])
    start = text + max(rows, cols)
    after = torch.arange(start, start + tail)[None].expand(3, tail)
    pos = torch.cat([head, grid, after], dim=1).to(torch.int32)
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous().to(device)


def mrope_leg(kern, dev) -> list:
    """qwen2-vl-72b, one layer at full width: the kernel forward at batch
    8 x 512 over image-grid M-RoPE positions (one flash and one signature
    launch, counted), the float32 kernel forward against the plain one,
    the same batch at text-only positions giving other logits (the
    sections act), then MROPE_TRAIN_STEPS AdamW steps at
    ``microbatches=2`` with the grid positions (``_split`` on axis 1).
    Returns the forward and training records."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Runtime
    from repro_torch.train.step import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    cfg = mrope_config()
    B = 8
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == tree_param_count(cfg) == MROPE_PARAMS,
          f"mrope: {n_params} parameters, expected {MROPE_PARAMS}")
    pipe = TokenPipeline(LM_DATA_VOCAB, B, 512, seed=0)
    it = iter(pipe)
    first = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_dict(next(it)).items()}
    pos = mrope_positions(B, dev)
    grid = {"tokens": first["tokens"], "positions": pos}
    rt = Runtime(use_kernels=True, want_signature=True)
    with torch.inference_mode():
        tfm.forward(params, grid, cfg, rt, mode="prefill")   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with PlainMeter(kern) as plain:
            reset_launches(kern)                   # counts start here
            t0 = time.perf_counter()
            logits, aux = tfm.forward(params, grid, cfg, rt, mode="prefill")
            torch.cuda.synchronize()
            forward_s = time.perf_counter() - t0
            counted = read_launches(kern)          # and are read here
    expected = expected_prefill_launches(cfg, prefills=0, signatures=1,
                                         forwards=1)
    check(counted["launches"] == expected and counted["flash_routes"]
          == {"sm90": 1, "fma": 0} and counted["signature_routes"]
          == {"vec": 1, "strided": 0} and not any(plain.calls.values()),
          f"mrope: launches {counted} (plain {plain.calls}), expected "
          f"{expected} on sm90 and vec")
    check(bool(torch.isfinite(logits).all()), "mrope: non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    check_free("mrope", peak)
    del logits, aux
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    with torch.inference_mode():
        k32, _ = tfm.forward(params, grid, cfg32, rt, mode="prefill")
        p32, _ = tfm.forward(params, grid, cfg32, Runtime(want_signature=True),
                             mode="prefill")
        err = (k32 - p32).abs().max().item()
        del p32
        text, _ = tfm.forward(params, {"tokens": first["tokens"]}, cfg32, rt,
                              mode="prefill")
        moved = (text - k32).abs().max().item()
        moved_rows = (text - k32).abs().amax(-1)[0] > SERVE_LOGIT_TOL
        del text, k32
    check(err <= SERVE_LOGIT_TOL, f"mrope: float32 kernel logits differ "
          f"from the plain forward's by {err}")
    text_len = MROPE_LAYOUT[0]
    check(moved > 10 * SERVE_LOGIT_TOL and not bool(
        moved_rows[:text_len].any()), f"mrope: text-only positions move "
          f"the logits by {moved}, and the leading text's rows "
          f"{int(moved_rows[:text_len].sum())} (should be 0): the sections "
          f"do not act as laid out")
    record = dict(
        phase="attention_variants_path", leg="mrope", model=cfg.name,
        mrope_sections=list(cfg.mrope_sections), layout=list(MROPE_LAYOUT),
        n_params=n_params, batch=B, seq_len=512, forward_ms=1e3 * forward_s,
        peak_bytes=peak,
        tokens_per_s=B * 512 / forward_s, float32_max_abs_err=err,
        float32_bound=SERVE_LOGIT_TOL, text_positions_max_abs_change=moved,
        rows_moved=int(moved_rows.sum()), plain_calls=plain.calls,
        leg_s=time.perf_counter() - t_leg, **counted)
    emit(**record)

    # training at two microbatches over the grid positions
    t_leg = time.perf_counter()
    step, opt = make_train_step(cfg, runtime=Runtime(want_signature=True),
                                microbatches=2)
    opt_state = opt.init(params)
    batches = [first] + [{k: torch.from_numpy(v).to(dev) for k, v in
                          pipe.batch_dict(next(it)).items()}
                         for _ in range(MROPE_TRAIN_STEPS - 1)]
    history = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PlainMeter(kern) as plain:
        reset_launches(kern)                       # counts start here
        for batch in batches:
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state,
                                        dict(batch, positions=pos))
            history.append((float(m["loss"]), time.perf_counter() - t0))
        torch.cuda.synchronize()
        train_counted = read_launches(kern)        # and are read here
    peak = torch.cuda.max_memory_allocated()
    del params, opt_state
    losses = [h[0] for h in history]
    signatures = 2 * MROPE_TRAIN_STEPS            # one a microbatch
    check(all(np.isfinite(losses)) and float(np.mean(losses[-3:]))
          < losses[0], f"mrope_train: losses {losses}")
    check(train_counted["launches"] == {"signature": signatures, "flash": 0,
                                        "scan": 0, "mlstm": 0, "slstm": 0}
          and train_counted["signature_routes"] == {"vec": signatures,
                                                    "strided": 0}
          and not any(plain.calls.values()), f"mrope_train: launches "
          f"{train_counted} (plain {plain.calls})")
    total = check_free("mrope_train", peak)
    step_s = [h[1] for h in history]
    ms = 1e3 * float(np.mean(step_s[1:]))
    train_record = dict(
        phase="attention_variants_path", leg="mrope_train", model=cfg.name,
        optimizer="adamw", remat=Runtime().remat,
        moment_dtype=cfg.moment_dtype, microbatches=2,
        batch=B, seq_len=512, steps=MROPE_TRAIN_STEPS, losses=losses,
        step_ms=[1e3 * t for t in step_s], ms_per_step=ms,
        tokens_per_s=B * 512 / (ms / 1e3), peak_bytes=peak, card_bytes=total,
        plain_calls=plain.calls, leg_s=time.perf_counter() - t_leg,
        **train_counted)
    emit(**train_record)
    return [record, train_record]


def phase_attention_variants_path(kern, dev) -> dict:
    """The attention variants at full width: gemma3-27b's sliding windows
    past 2,048 tokens (backend, local training, serving), deepseek-v2's
    MLA over MoE (backend and serving, and the dense prologue's training)
    and qwen2-vl-72b's M-RoPE (forwards and training)."""
    t0 = time.perf_counter()
    legs = {}
    for record in gemma3_backend_leg(kern, dev):
        legs[record["leg"]] = record
    legs["gemma3_serve"] = serve_leg(
        kern, dev, "gemma3_serve", gemma3_config(), GEMMA3_PARAMS,
        batch=GEMMA3_BATCH, prompt_len=GEMMA3_SEQ, new_tokens=GEMMA3_NEW,
        phase="attention_variants_path")
    with ScoreMeter() as shapes:
        legs["mla_backend"] = moe_backend_leg(
            kern, dev, mla_config(), leg="mla_backend",
            phase="attention_variants_path", expected_params=MLA_PARAMS)
    head_dims = sorted(set(hd for hd, _ in shapes.flash))
    check(head_dims == [192], f"mla_backend: flash asked for head dims "
          f"{head_dims}, expected MLA's 192")
    legs["mla_backend"]["flash_head_dims"] = head_dims
    legs["mla_serve"] = serve_leg(kern, dev, "mla_serve", mla_config(),
                                  MLA_PARAMS,
                                  phase="attention_variants_path")
    legs["mla_train"] = moe_train_leg(kern, dev, mla_prologue_config(),
                                      leg="mla_train",
                                      phase="attention_variants_path")
    for record in mrope_leg(kern, dev):
        legs[record["leg"]] = record
    emit(phase="attention_variants_path_done",
         seconds=time.perf_counter() - t0)
    return legs


def whisper_query_leg(kern, dev, cfg) -> dict:
    """The consensus-serving query driver on the served weights (seed 0):
    one ``LMQueryDriver.decode_prompts`` call (zero frame embeddings, as
    the reference's ``LMQueryDriver``) with the launch counts set to 0
    just before and read just after (one prefill on the kernels), its
    tokens bit-equal to ``launch.serve.greedy_decode`` on the same prompts
    with zero frame embeddings."""
    import gc

    import numpy as np
    import torch
    from repro_torch.fl.serving import LMQueryDriver
    from repro_torch.launch import serve as launch
    from repro_torch.models import transformer as tfm

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    batch, prompt_len, new_tokens = WHISPER_QUERY
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt_len))
    driver = LMQueryDriver(cfg, query_batch=batch, prompt_len=prompt_len,
                           new_tokens=new_tokens)
    driver.decode_prompts(params, prompts[:, :16])        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with PlainMeter(kern) as plain:
        reset_launches(kern)                       # counts start here
        t0 = time.perf_counter()
        tokens = driver.decode_prompts(params, prompts)
        wall = time.perf_counter() - t0
        counted = read_launches(kern)              # and are read here
    peak = torch.cuda.max_memory_allocated()
    check_free("whisper_query", peak)
    expected = expected_prefill_launches(cfg, prefills=1)
    check(counted["launches"] == expected and not any(plain.calls.values())
          and counted["flash_routes"] == {"sm90": expected["flash"],
                                          "fma": 0},
          f"whisper_query: launches {counted['launches']} by route "
          f"{counted['flash_routes']} (plain {plain.calls}), expected "
          f"{expected}")
    prefill, decode = launch.make_serving_fns(cfg)
    want = launch.greedy_decode(prefill, decode, cfg, params, {
        "tokens": torch.as_tensor(prompts, device=dev),
        "enc_embed": torch.zeros((batch, cfg.encoder.n_ctx, cfg.d_model),
                                 device=dev)}, new_tokens)["tokens"]
    want = want.cpu().numpy()
    check(tokens.shape == (batch, new_tokens) and np.array_equal(tokens,
                                                                 want),
          f"whisper_query: LMQueryDriver's tokens differ from "
          f"greedy_decode's at {int((tokens != want).sum())} of "
          f"{want.size}")
    # one prefill of the query batch under the profiler: where its time
    # goes (the encoder's dense float32 scores against the products)
    query = driver.make_batch(prompts, dev)

    def one_prefill():
        prefill(params, query)
        torch.cuda.synchronize()

    traced, prefill_wall = profiled(one_prefill)
    busy_us, spans, top = device_busy(traced)
    del params
    record = dict(
        phase="whisper_path", leg="whisper_query", model=cfg.name,
        batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
        query_ms=1e3 * wall, tokens_equal_greedy_decode=True,
        prefill_profile={
            "wall_ms": 1e3 * prefill_wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": (1.0 - busy_us / 1e6 / prefill_wall
                                  if spans else None),
            "device_kernels": len(spans),
            "top_device_ms": [[k[:90], ms, n] for k, ms, n in top[:12]]},
        peak_bytes=peak, plain_calls=plain.calls,
        leg_s=time.perf_counter() - t_leg,
        **counted)
    emit(**record)
    return record


def whisper_zero_frames_step(dev, cfg) -> dict:
    """One step of ``train_single`` with the reference's zero frame
    embeddings at full depth: the layer norms of the zero rows scale the
    backward by 1/sqrt(eps) each, so over 24 encoder layers the gradient
    overflows (the reference's own function, ROADMAP Queue 3): its norm
    must come out non-finite, and the loss before the update finite."""
    import argparse
    import gc

    import numpy as np
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch

    gc.collect()
    torch.cuda.empty_cache()
    batch, seq = WHISPER_TRAIN
    args = argparse.Namespace(steps=1, batch=batch, seq=seq, seed=0,
                              device=str(dev), log_every=1, checkpoint="")
    history = []
    params = launch.train_single(
        cfg, args, pipe=TokenPipeline(LM_DATA_VOCAB, batch, seq, seed=0),
        history=history)
    del params
    loss, gnorm = history[0]["loss"], history[0]["grad_norm"]
    check(np.isfinite(loss) and not np.isfinite(gnorm),
          f"whisper_zero_frames: loss {loss}, grad norm {gnorm}: expected "
          f"the reference's overflow (a non-finite grad norm)")
    record = dict(phase="whisper_path", leg="whisper_zero_frames",
                  loss=loss, grad_norm=str(gnorm), batch=batch, seq_len=seq)
    emit(**record)
    return record


def phase_whisper_path(kern, dev) -> dict:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers, 959,329,280 parameters) through the reference's entry points:
    the serve launcher, the consensus-serving query driver and the
    single-stream trainer (one step on the reference's zero frames, whose
    gradient overflows, then 10 steps on frames drawn from seed 1)."""
    import torch
    t0 = time.perf_counter()
    cfg = whisper_config()
    batch, prompt_len, new_tokens = WHISPER_SERVE
    train_batch, train_seq = WHISPER_TRAIN
    legs = {"whisper_serve": serve_leg(
                kern, dev, "whisper_serve", cfg, WHISPER_PARAMS, batch=batch,
                prompt_len=prompt_len, new_tokens=new_tokens,
                phase="whisper_path"),
            "whisper_query": whisper_query_leg(kern, dev, cfg)}
    zero = whisper_zero_frames_step(dev, cfg)
    frames = torch.randn((train_batch, cfg.encoder.n_ctx, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev) * 0.1
    legs["whisper_train"] = moe_train_leg(
        kern, dev, cfg, leg="whisper_train", phase="whisper_path",
        batch=train_batch, seq=train_seq, expected_params=WHISPER_PARAMS,
        enc_embed=frames)
    legs["whisper_train"]["zero_frames_step"] = zero
    del frames
    emit(phase="whisper_path_done", seconds=time.perf_counter() - t0)
    return legs


MESH_TOL = {"weights": 5e-3, "losses": 5e-2, "accuracy": 1e-4,
            "signature": 1e-2, "aggregate": 1e-6}   # tests/test_cohort_mesh.py
MESH_CNN_SIZES = (100, 160, 230, 130, 190)   # ragged shards, batch 64
MESH_LM = (2, 4, 512)                        # clients, batch, positions
MESH_SLSTM = {"forward": (8, 512), "backward": (4, 128)}   # batch, tokens
MESH_SLSTM_TOL = 1e-5          # weight gradients, of their scale
# the sharded float32 logits, of the largest logit: a shard's gate
# projection is its own cuBLAS product (4.8e-6 off the whole batch's on
# an H100), which left them 6.25e-5 of 3.19 apart (2.0e-5) after 12 layers;
# the limit is 10 times that
MESH_SLSTM_LOGIT_TOL = 2e-4


def mesh_cnn_world():
    """VGG16 at full width over the CNN world's pooled train set cut into
    ragged shards of ``MESH_CNN_SIZES`` (every shard also its client's
    validation set)."""
    from repro_torch.data.synthetic import Dataset
    cfg, client_data, test, pooled = cnn_world()
    shards, start = [], 0
    for n in MESH_CNN_SIZES:
        shards.append(Dataset(pooled.x[start:start + n],
                              pooled.y[start:start + n]))
        start += n
    return cfg, shards, client_data, test


def mesh_lm_config():
    """internlm2-1.8b at full width, 2 layers."""
    import dataclasses
    return dataclasses.replace(lm_config(), n_layers=2, stages=(
        dataclasses.replace(lm_config().stages[0], repeats=2),))


def tree_err(a, b) -> float:
    """Largest absolute difference of two congruent trees."""
    from repro_torch.core.aggregate import tree_leaves
    return max(float((x.float() - y.float().to(x.device)).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def engine_against_single(leg, single, meshed, params, shards, seeds,
                          sync) -> dict:
    """Every engine call of ``meshed`` against ``single`` on the same
    inputs, at ``MESH_TOL``; returns the largest errors and the meshed
    calls' seconds."""
    import numpy as np
    out, seconds = {}, {}

    def both(name, fn):
        t = time.perf_counter()
        got = fn(meshed)
        sync()
        seconds[name] = time.perf_counter() - t
        return fn(single), got

    (p1, l1), (p2, l2) = both("train_cohort", lambda e: e.train_cohort(
        params, shards, seeds))
    out["weights"] = max(tree_err(a, b) for a, b in zip(p1, p2))
    out["losses"] = float(np.max(np.abs(np.subtract(l1, l2))))
    a1, a2 = both("evaluate_cohort", lambda e: e.evaluate_cohort(p1, shards))
    s1, s2 = both("evaluate_shared", lambda e: e.evaluate_shared(p1[0],
                                                                 shards))
    m1, m2 = both("evaluate_many", lambda e: e.evaluate_many(p1, shards[0]))
    out["accuracy"] = float(np.max(np.abs(np.subtract(
        a1 + s1 + m1, a2 + s2 + m2))))
    g1, g2 = both("signature_cohort", lambda e: e.signature_cohort(p1,
                                                                   shards))
    out["signature"] = float(np.max(np.abs(g1 - g2)))
    for key, err in out.items():
        check(err <= MESH_TOL[key], f"{leg}: {key} differ by {err} > "
              f"{MESH_TOL[key]} from the single-device engine")
    out["bit_equal"] = {"weights": out["weights"] == 0.0,
                        "signature": out["signature"] == 0.0}
    return {"errors": out, "seconds": seconds}


def mesh_auto_leg(kern, dev, cfg, backend, shards) -> dict:
    """``mesh="auto"``: on one card the single-device engine, bit for bit
    against ``mesh=None`` with ``cudnn.deterministic``.  Once before it
    with cuDNN's default algorithms, reported: those are not
    deterministic, and two runs of one program differ in training's last
    bits."""
    import torch
    from repro_torch.fl.cohort import build_cohort_engine
    auto = build_cohort_engine(backend, cohort_size=4, mesh="auto")
    none = build_cohort_engine(backend, cohort_size=4, mesh=None)
    params = [backend.init(torch.Generator().manual_seed(s))
              for s in range(3)]
    default = engine_against_single("mesh_auto", none, auto, params,
                                    shards[:3], [11, 12, 13],
                                    torch.cuda.synchronize)["errors"]
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        reset_launches(kern)
        res = engine_against_single("mesh_auto", none, auto, params,
                                    shards[:3], [11, 12, 13],
                                    torch.cuda.synchronize)
        launches = read_launches(kern)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    one = torch.cuda.device_count() == 1
    if one:
        check(auto.mesh is None, "mesh_auto: one card built a mesh")
        check(all(res["errors"]["bit_equal"].values())
              and res["errors"]["accuracy"] == 0.0,
              f"mesh_auto: not bit-equal to mesh=None {res['errors']}")
    emit(phase="mesh_path", leg="mesh_auto", model=cfg.name,
         mesh=None if auto.mesh is None else dict(auto.mesh.shape),
         device_count=torch.cuda.device_count(), default_algorithms=default,
         **res, **launches)
    return launches


def mesh_cnn_leg(kern, dev, cfg, backend, shards, devices, label) -> dict:
    """A 1-D mesh of 2 devices and a 2x2 mesh of 4 over ``devices``, with
    a ragged K of 3 and 5, against the single-device engine; the stacked
    reductions over both meshes at 1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.aggregate import (stacked_mean, stacked_weighted,
                                            tree_stack)
    from repro_torch.fl.cohort import CohortBackend
    from repro_torch.launch.mesh import make_cohort_mesh
    single = CohortBackend(backend)
    reset_launches(kern)
    runs = {}
    for name, (c, d) in {"1d": (2, 1), "2x2": (2, 2)}.items():
        if len(devices) < c * d:
            continue
        mesh = make_cohort_mesh(c, data=d, devices=devices[:c * d])
        meshed = CohortBackend(backend, mesh=mesh)
        check(dict(meshed.mesh.shape) == ({"clients": 2} if d == 1 else
                                          {"clients": 2, "data": 2}),
              f"{label}: mesh {mesh}")
        for k in (3, 5):
            params = [backend.init(torch.Generator().manual_seed(s))
                      for s in range(k)]
            runs[f"{name}_k{k}"] = engine_against_single(
                label, single, meshed, params, shards[:k],
                list(range(21, 21 + k)), torch.cuda.synchronize)
        stacked = tree_stack([backend.init(torch.Generator().manual_seed(s))
                              for s in range(5)])
        w = np.random.default_rng(0).random((3, 5)).astype(np.float32)
        err = max(tree_err(stacked_mean(stacked),
                           stacked_mean(stacked, mesh=mesh,
                                        data_axis="data")),
                  tree_err(stacked_weighted(stacked, w),
                           stacked_weighted(stacked, w, mesh=mesh,
                                            data_axis="data")))
        check(err <= MESH_TOL["aggregate"], f"{label}: stacked aggregation "
              f"over {name} differs by {err}")
        runs[f"{name}_aggregate_err"] = err
    launches = read_launches(kern)
    emit(phase="mesh_path", leg=label, model=cfg.name,
         devices=[str(d) for d in devices], runs=runs, **launches)
    return launches


def mesh_dag_leg(kern, dev, cfg, backend, client_data, test) -> dict:
    """DAG-AFL, 4 clients, 2 rounds, on the 2x2 mesh and without a mesh in
    the same call (none, mesh, none again): every round, a verified DAG,
    ``s_per_round`` of each; returns the mesh run's launches."""
    import torch
    from repro_torch.core.coordinator import DagAflConfig, DagAflCoordinator
    from repro_torch.core.verify import verify_full_dag
    from repro_torch.launch.mesh import make_cohort_mesh
    out = {}
    for name, mesh in (("none", None), ("2x2", make_cohort_mesh(
            2, data=2, devices=[dev] * 4)), ("none_again", None)):
        coord = DagAflCoordinator(backend, client_data, test, DagAflConfig(
            n_clients=4, max_rounds=2, local_epochs=1, cohort_size=4,
            cohort_window=2.0, mesh=mesh))
        torch.cuda.synchronize()
        reset_launches(kern)
        t0 = time.perf_counter()
        result = coord.run(backend.init(torch.Generator().manual_seed(0)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok, why = verify_full_dag(coord.ledger)
        check(result.rounds == 8 and result.extra["chain_len"]
              == 1 + result.rounds, f"mesh_dag {name}: {result.rounds} "
              f"rounds, chain {result.extra['chain_len']}")
        check(ok and result.extra["verify_failures"] == 0,
              f"mesh_dag {name}: {why}")
        check((coord.cohort.mesh is not None) == (mesh is not None),
              f"mesh_dag {name}: engine mesh {coord.cohort.mesh}")
        counted = read_launches(kern)
        out[name] = {"s_per_round": wall / result.rounds,
                     "final_accuracy": result.final_accuracy,
                     "cohorts_dispatched":
                         result.extra["cohorts_dispatched"],
                     "launches": counted["launches"]}
        if mesh is not None:
            launches = counted
    emit(phase="mesh_path", leg="mesh_dag", model=cfg.name, runs=out)
    return launches


def mesh_lm_leg(kern, dev, devices, label) -> dict:
    """internlm2-1.8b at full width and 2 layers, K = 2 on a 2x1 mesh
    over ``devices``: flash and the signature launched per group, counted,
    and every call against the single-device engine."""
    import gc

    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.fl.backend import LMBackend
    from repro_torch.fl.cohort import CohortBackend
    from repro_torch.launch.mesh import make_cohort_mesh
    gc.collect()
    torch.cuda.empty_cache()
    cfg = mesh_lm_config()
    clients, batch, seq = MESH_LM
    streams, _ = lm_streams(clients)
    backend = LMBackend(cfg, lr=3e-3, local_steps=2, batch_size=batch,
                        seq_len=seq, device=dev)
    single = CohortBackend(backend)
    meshed = CohortBackend(backend, mesh=make_cohort_mesh(
        2, devices=devices[:2]))
    params = [backend.init(torch.Generator(device=dev).manual_seed(s))
              for s in range(clients)]
    warm, _ = meshed.train_cohort(params, streams, [0, 1], epochs=1)
    meshed.evaluate_cohort(warm, streams)
    del warm
    trained, _ = single.train_cohort(params, streams, [3, 4])
    torch.cuda.synchronize()
    reset_launches(kern)                           # counts start here
    t0 = time.perf_counter()
    got_p, _ = meshed.train_cohort(params, streams, [3, 4])
    accs = meshed.evaluate_cohort(trained, streams)
    sigs = meshed.signature_cohort(trained, streams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kern)                 # and are read here
    n = launches["launches"]
    layers = cfg.n_layers
    check(n["flash"] == 2 * clients * layers
          == launches["flash_routes"]["sm90"],
          f"{label}: {n['flash']} flash launches for {clients} evaluation "
          f"and {clients} signature forwards of {layers} layers "
          f"{launches['flash_routes']}")
    check(n["signature"] == clients == launches["signature_routes"]["vec"],
          f"{label}: {n['signature']} signature launches for {clients} "
          f"clients {launches['signature_routes']}")
    check(not (n["scan"] or n["mlstm"] or n["slstm"]),
          f"{label}: other kernels {n}")
    import numpy as np
    errs = {"weights": max(tree_err(a, b) for a, b in zip(trained, got_p)),
            "accuracy": float(np.max(np.abs(np.subtract(
                single.evaluate_cohort(trained, streams), accs)))),
            "signature": float(np.max(np.abs(
                single.signature_cohort(trained, streams) - sigs)))}
    for key, err in errs.items():
        check(err <= MESH_TOL[key], f"{label}: {key} differ by {err}")
    home = torch.empty(0, device=backend.device).device   # with its index
    check(all(p.device == home for m in got_p for p in tree_leaves(m)),
          f"{label}: the trained models left the engine's device")
    emit(phase="mesh_path", leg=label, model=cfg.name,
         devices=[str(d) for d in devices[:2]], wall_s=wall, errors=errs,
         bit_equal={k: v == 0.0 for k, v in errs.items()}, **launches)
    del backend, single, meshed, params, trained, got_p
    return launches


def mesh_slstm_leg(kern, dev) -> dict:
    """xlstm-125m's forward with ``Runtime(mesh=..., batch_axes=...)`` over
    2 batch devices: the sLSTM kernel once a shard and layer.  Each sLSTM
    layer's sharded scan against the unsharded scan on the same inputs
    (taken from the unsharded float32 forward) at the reference's sLSTM
    tolerances (``SLSTM_TOL``); the whole forward's float32 logits
    against the unsharded forward's within ``MESH_SLSTM_LOGIT_TOL`` of the
    largest, their error and whether they are bit-equal reported (and the
    model's bfloat16 ones).  A shard computes its rows' gate projection
    as one product, which cuBLAS may sum in another order than the whole
    batch's: the leg reads the gates of 4 of 8 rows against the whole
    batch's, and the kernel on the same gates row by row.  Then one
    backward on the plain path: each layer's sharded scan under a fixed
    upstream gradient, its gate weights' gradients within 1e-5 of their
    scale of the unsharded scan's; the whole loss's gradients of those
    weights reported (they carry every layer's gate-projection
    differences)."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models import xlstm
    from repro_torch.runtime import Runtime
    gc.collect()
    torch.cuda.empty_cache()
    base = xlstm_config()
    mesh = Mesh(np.asarray([dev] * 2, dtype=object), ("data",))
    sharded = dict(mesh=mesh, batch_axes=("data",), batch_axis_size=2)
    n_slstm = sum(spec.kind == "slstm" for spec in base.layer_specs())
    out = {}
    g = torch.Generator(device=dev).manual_seed(5)
    B, S = MESH_SLSTM["forward"]
    toks = torch.randint(0, LM_DATA_VOCAB, (B, S), generator=g, device=dev)
    launches = None
    scan = xlstm._slstm_scan_maybe_sharded
    for compute in ("float32", base.compute_dtype):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg)
        calls = []

        def keep(*args):
            calls.append(args)
            return scan(*args)

        xlstm._slstm_scan_maybe_sharded = keep
        try:
            with torch.inference_mode():
                want, _ = tfm.forward(params, {"tokens": toks}, cfg,
                                      Runtime(use_kernels=True))
        finally:
            xlstm._slstm_scan_maybe_sharded = scan
        with torch.inference_mode():
            torch.cuda.synchronize()
            reset_launches(kern)
            got, _ = tfm.forward(params, {"tokens": toks}, cfg,
                                 Runtime(use_kernels=True, **sharded))
            torch.cuda.synchronize()
            counted = read_launches(kern)
            layers = []
            for p, xconv, state, rt in calls:
                hs, core = scan(p, xconv, state, Runtime(use_kernels=True,
                                                         **sharded))
                ref_hs, ref_core = scan(p, xconv, state, rt)
                err = {"hs": float((hs - ref_hs).abs().max()),
                       "state": max(float((core[k] - ref_core[k]).abs().max())
                                    for k in ref_core)}
                for key, t, r in (("hs", hs, ref_hs),) + tuple(
                        ("state", core[k], ref_core[k]) for k in ref_core):
                    check(bool(torch.allclose(t, r, rtol=SLSTM_TOL[key],
                                              atol=SLSTM_TOL[key])),
                          f"mesh_slstm ({compute}): a sharded scan's {key} "
                          f"past {SLSTM_TOL[key]}: {err}")
                layers.append(err)
        if launches is None:
            launches = counted
        sl = kern["sl"]
        units = sl.units_per_block(cfg.d_model, torch.cuda
                                   .get_device_properties(dev)
                                   .multi_processor_count)
        rows = sl.row_plan(B // 2, cfg.d_model, units)
        expected = n_slstm * 2 * -(-(B // 2) // rows)   # row slices
        check(len(calls) == n_slstm
              and counted["launches"]["slstm"] == expected,
              f"mesh_slstm: {counted['launches']['slstm']} sLSTM launches, "
              f"{expected} for 2 shards of {B // 2} rows in {n_slstm} "
              f"layers ({len(calls)} scans)")
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        out[compute] = {"scans": layers, "logits_err": err,
                        "logits_scale": scale,
                        "bit_equal": bool(torch.equal(got, want))}
        # the model's bfloat16 layers carry one-ulp flips on to the logits
        # (the xLSTM path's reason): gated in float32, reported in bf16
        check(compute != "float32" or err <= MESH_SLSTM_LOGIT_TOL * scale,
              f"mesh_slstm: sharded float32 logits differ by {err} of "
              f"{scale}")
        if compute == "float32":
            calls_f32 = calls
        del params, want, got, calls
    # where the sharded logits depart: one layer's gate projection over the
    # first shard's rows against the whole batch's, and the kernel on the
    # same gates over those rows (reported)
    p, xconv, state, _ = calls_f32[0]
    half = B // 2
    with torch.inference_mode():
        gates, R = xlstm._slstm_inputs(p, xconv)
        shard_gates, _ = xlstm._slstm_inputs(p, xconv[:half])
        whole = kern["sl"].slstm_scan_bsd(gates, R, state["c"], state["n"],
                                          state["h"], state["m"])[0]
        rows = kern["sl"].slstm_scan_bsd(
            gates[:half].contiguous(), R,
            *(state[k][:half] for k in ("c", "n", "h", "m")))[0]
    out["gate_projection_err"] = float((gates[:half] - shard_gates).abs()
                                       .max())
    out["kernel_rows_bit_equal"] = bool(torch.equal(whole[:half], rows))
    del calls_f32, gates, shard_gates, whole, rows
    # one backward: each sLSTM layer's scan on the plain forward's inputs
    # under a fixed upstream gradient, sharded against unsharded (gated);
    # then the whole loss's gradients of those weights (reported)
    cfg = dataclasses.replace(base, compute_dtype="float32")
    B, S = MESH_SLSTM["backward"]
    toks = torch.randint(0, LM_DATA_VOCAB, (B, S + 1), generator=g,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    calls = []

    def keep(*args):
        calls.append(args)
        return scan(*args)

    xlstm._slstm_scan_maybe_sharded = keep
    try:
        with torch.no_grad():
            tfm.forward(params, {"tokens": batch["tokens"]}, cfg, Runtime())
    finally:
        xlstm._slstm_scan_maybe_sharded = scan
    names = ("w_gates", "r_gates", "b_gates")
    layer_rel = []
    for p, xconv, state, _ in calls:
        upstream = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
        grads = []
        for rt in (Runtime(), Runtime(**sharded)):
            w = {k: p[k].detach().clone().requires_grad_(True)
                 for k in names}
            hs, _ = scan(dict(p, **w), xconv, state, rt)
            (hs * upstream).sum().backward()
            grads.append({k: w[k].grad for k in names})
        layer_rel.append(max(float((grads[1][k] - v).abs().max()
                                   / v.abs().max())
                             for k, v in grads[0].items()))
    out["scan_weight_grad_rel_err"] = layer_rel
    check(len(layer_rel) == n_slstm and max(layer_rel) <= MESH_SLSTM_TOL,
          f"mesh_slstm: a sharded scan's weight gradients differ by "
          f"{layer_rel} of their scale")
    grads = []
    for rt in (Runtime(), Runtime(**sharded)):
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        tfm.loss_fn(params, batch, cfg, rt)[0].backward()
        grads.append({k: params["stages"][0][f"l{j}"]["core"][k].grad.clone()
                      for j, spec in enumerate(cfg.stages[0].pattern)
                      if spec.kind == "slstm" for k in names})
    out["loss_weight_grad_rel_err"] = max(
        float((grads[1][k] - v).abs().max() / v.abs().max())
        for k, v in grads[0].items())
    emit(phase="mesh_path", leg="mesh_slstm", model=base.name,
         forward=MESH_SLSTM["forward"], backward=MESH_SLSTM["backward"],
         results=out, **launches)
    del params, grads
    return launches


def phase_mesh_path(kern, dev) -> dict:
    """The cohort engine and the sLSTM scan over device meshes: repeated
    devices (``[cuda:0] * n``) exercise the grouped programs on one card;
    with more than one card the CNN and LM legs also run over distinct
    cards."""
    import torch
    t0 = time.perf_counter()
    from repro_torch.fl.backend import CNNBackend
    cfg, shards, client_data, test = mesh_cnn_world()
    backend = CNNBackend(cfg, local_epochs=1, batch_size=64, device=dev)
    n_cards = torch.cuda.device_count()
    emit(phase="mesh_path", device_count=n_cards)
    legs = {"cnn_mesh_auto": mesh_auto_leg(kern, dev, cfg, backend, shards),
            "cnn_mesh": mesh_cnn_leg(kern, dev, cfg, backend, shards,
                                     [dev] * 4, "mesh_cnn")}
    legs["cnn_mesh_dag"] = mesh_dag_leg(kern, dev, cfg, backend,
                                        client_data, test)
    legs["lm_mesh"] = mesh_lm_leg(kern, dev, [dev] * 2, "mesh_lm")
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        legs["cnn_mesh_cards"] = mesh_cnn_leg(kern, dev, cfg, backend,
                                              shards, cards, "mesh_cnn_cards")
        legs["lm_mesh_cards"] = mesh_lm_leg(kern, dev, cards,
                                            "mesh_lm_cards")
    legs["xlstm_mesh"] = mesh_slstm_leg(kern, dev)
    emit(phase="mesh_path_done", seconds=time.perf_counter() - t0,
         device_count=n_cards)
    return legs


def dense_backend_leg(kern, dev, leg: str, cfg, expected_params: int,
                      batch: int, seq: int) -> dict:
    """A dense config whole at full width: ``LMBackend.evaluate`` and
    ``signature`` at ``batch`` x ``seq`` with the launch counts set to 0
    just before and read just after (flash once a layer a forward, all on
    sm90 and counted by window; one signature launch a signature call, on
    vec; no plain call), then the kernel forward against the plain forward
    (past 2,048 tokens banded and chunked, else the dense scores, each
    counted) in float32 (checked) and bfloat16 (reported)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.aggregate import tree_leaves
    from repro_torch.fl.backend import LMBackend
    from repro_torch.models import transformer as tfm

    gc.collect()
    torch.cuda.empty_cache()
    t_leg = time.perf_counter()
    streams, global_test = lm_streams(2)
    backend = LMBackend(cfg, lr=3e-3, local_steps=2, batch_size=batch,
                        seq_len=seq)
    check(backend.device.type == "cuda", f"{leg}: backend is not on the "
          f"card")
    t0 = time.perf_counter()
    params = backend.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == tree_param_count(cfg) == expected_params,
          f"{leg}: {n_params} parameters, expected {expected_params}")
    with ScoreMeter() as shapes:
        counted, seconds, accs, peak, plain_calls = backend_calls(
            kern, leg, cfg, backend, params, streams)
    asked = sorted(set(shapes.flash))
    want = sorted({(cfg.head_dim, tfm.resolve_window(cfg, spec, seq))
                   for spec in cfg.layer_specs()})
    check(asked == want, f"{leg}: flash asked for (head_dim, window) "
          f"{asked}, expected {want}")
    tokens = backend._batch(backend._sample(
        global_test, np.random.default_rng(3), 1)[0])["tokens"]
    checks = {c: long_forward_check(tfm, cfg, params, tokens, c,
                                    checked=c == "float32", leg=leg)
              for c in ("float32", "bfloat16")}
    record = dict(
        phase="dense_configs_path", leg=leg, model=cfg.name,
        windows=[s.window for s in cfg.layer_specs()],
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
        attn_softcap=cfg.attn_softcap, n_params=n_params, batch=batch,
        seq_len=seq, data_vocab=LM_DATA_VOCAB, init_s=init_s,
        evaluate_ms=seconds["evaluate"], signature_ms=seconds["signature"],
        evaluate_tokens_per_s=batch * seq / (
            np.mean(seconds["evaluate"]) / 1e3),
        accuracies=accs, peak_bytes=peak, plain_calls=plain_calls,
        forward_check=checks, leg_s=time.perf_counter() - t_leg, **counted)
    emit(**record)
    del params, backend
    return record


def remat_check(dev, cfg, batch: int, seq: int) -> dict:
    """The loss gradient of the train step's arithmetic (the loss of the
    weights cast to the compute type, its backward into the float32
    masters) from the same weights (seed 0) and batch, after one warm-up
    with and one without remat, in turns: without, with, with, without.
    The gradients with remat bit for bit those of the first run without,
    or no further from them than the second run without (the card's
    floor); the ms of each setting (the mean of its two runs) and its
    peak."""
    import gc

    import torch
    from repro_torch.core.aggregate import tree_leaves, tree_map
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import torch_dtype
    from repro_torch.runtime import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    leaves = tree_leaves(params)
    pipe = TokenPipeline(LM_DATA_VOCAB, batch, seq, seed=0)
    data = {k: torch.from_numpy(v).to(dev)
            for k, v in pipe.batch_dict(next(iter(pipe))).items()}
    compute = torch_dtype(cfg.compute_dtype)

    def gradient(remat: bool):
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cast = tree_map(lambda a: a.to(compute) if a.is_floating_point()
                        and a.dtype != compute else a, params)
        loss, _ = tfm.loss_fn(cast, data, cfg, Runtime(remat=remat))
        loss.backward()
        del cast
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        grads = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return (float(loss.detach()), grads, ms,
                torch.cuda.max_memory_allocated())

    def max_diff(a, b) -> float:
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    gradient(False)                    # warm-up of each, outside the record
    gradient(True)
    loss_off, off, ms, peak_off = gradient(False)
    ms_by = {False: [ms], True: []}
    equal, diff, losses = True, 0.0, []
    for remat in (True, True, False):
        loss, grads, ms, peak = gradient(remat)
        ms_by[remat].append(ms)
        if remat:
            losses.append(loss)
            peak_on = peak
            same = all(torch.equal(a, b) for a, b in zip(off, grads))
            equal = equal and same
            diff = max(diff, 0.0 if same else max_diff(off, grads))
        else:
            floor = max_diff(off, grads)
        del grads
    del off
    loss_on = losses[0]
    check(equal or diff <= floor, f"remat_check: the gradients with remat "
          f"differ from those without by {diff}, more than two runs without "
          f"remat ({floor})")
    check(all(loss == loss_off for loss in losses), f"remat_check: losses "
          f"{losses} with remat, {loss_off} without")
    for p in leaves:
        p.requires_grad_(False)
    del params, leaves
    return {"batch": batch, "seq_len": seq, "loss": loss_on,
            "grads_bit_equal": equal, "grads_max_abs_diff": diff,
            "floor_max_abs_diff": floor,
            "loss_and_gradient_ms": {"remat": sum(ms_by[True]) / 2,
                                     "no_remat": sum(ms_by[False]) / 2},
            "loss_and_gradient_ms_runs": {"remat": ms_by[True],
                                          "no_remat": ms_by[False]},
            "peak_bytes": {"remat": peak_on, "no_remat": peak_off}}


def phase_dense_configs_path(kern, dev) -> dict:
    """gemma2-2b and qwen2-7b whole at full width (random weights from
    seed 0, data from the LM paths' sub-vocabulary), each leg with the
    launch counts set to 0 just before and read just after and its peak
    leaving 5 GB of the card free: ``gemma2_backend`` (2 x 8,192, flash 13
    times at window 4,096 and 13 at -1 a forward), ``gemma2_train``
    (TRAIN_STEPS AdamW steps of ``train_single`` with remat at
    GEMMA2_TRAIN, then ``remat_check`` at GEMMA2_REMAT_CHECK),
    ``gemma2_serve`` (2 x (8,192 + 32)), ``qwen2_backend`` (8 x 512, flash
    28 times a forward at a GQA group of 7), ``qwen2_serve`` (8 x (512 +
    64)) and ``qwen2_train`` (TRAIN_STEPS AdamW steps at 8 x 512 on the
    cut ``qwen2_train_config``)."""
    t0 = time.perf_counter()
    gemma2, qwen2 = gemma2_config(), qwen2_config()
    legs = {"gemma2_backend": dense_backend_leg(
        kern, dev, "gemma2_backend", gemma2, GEMMA2_PARAMS, GEMMA2_BATCH,
        GEMMA2_SEQ)}
    batch, seq = GEMMA2_TRAIN
    legs["gemma2_train"] = moe_train_leg(
        kern, dev, gemma2, leg="gemma2_train", phase="dense_configs_path",
        batch=batch, seq=seq, expected_params=GEMMA2_PARAMS)
    record = remat_check(dev, gemma2, *GEMMA2_REMAT_CHECK)
    emit(phase="dense_configs_path", leg="gemma2_remat_check",
         model=gemma2.name, **record)
    legs["gemma2_train"]["remat_check"] = record
    legs["gemma2_serve"] = serve_leg(
        kern, dev, "gemma2_serve", gemma2, GEMMA2_PARAMS, batch=GEMMA2_BATCH,
        prompt_len=GEMMA2_SEQ, new_tokens=GEMMA2_NEW,
        phase="dense_configs_path")
    legs["qwen2_backend"] = dense_backend_leg(
        kern, dev, "qwen2_backend", qwen2, QWEN2_PARAMS, 8, 512)
    legs["qwen2_serve"] = serve_leg(kern, dev, "qwen2_serve", qwen2,
                                    QWEN2_PARAMS,
                                    phase="dense_configs_path")
    legs["qwen2_train"] = moe_train_leg(
        kern, dev, qwen2_train_config(), leg="qwen2_train",
        phase="dense_configs_path", expected_params=QWEN2_TRAIN_PARAMS)
    legs["qwen2_train"]["layers"] = QWEN2_TRAIN_LAYERS
    emit(phase="dense_configs_path_done", seconds=time.perf_counter() - t0)
    return legs


_DRYRUN_COUNT = r"""
import dataclasses, json, sys, time
sys.path.insert(0, "src")
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import CostCount
from repro_torch.launch.mesh import dtensor_mesh, make_host_mesh
from repro_torch.sharding.rules import MeshPlan

out = []
for arch, mode, batch, seq in CASES:
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="bfloat16",
                              cache_dtype="bfloat16")
    mesh = make_host_mesh(4, 2, devices=[torch.device("meta")] * 8)
    t0 = time.perf_counter()
    with dtensor_mesh(mesh) as dmesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        step, _, _ = dryrun.build_step(
            cfg, InputShape("smoke", seq, batch, mode), mesh, MeshPlan(),
            dmesh)
        with CostCount() as cost:
            step()
    out.append({"arch": arch, "mode": mode, "flops_per_chip": cost.flops,
                "bytes_per_chip": cost.bytes,
                "collectives": dict(cost.colls),
                "peak_bytes_per_chip": cost.peak_bytes,
                "count_s": time.perf_counter() - t0,
                "group_left": dist.is_initialized()})
print(json.dumps({"torch": torch.__version__, "cases": out}))
"""


def phase_dryrun_path() -> dict:
    """The dry run's sharded count of DRYRUN_CASES in a subprocess (a
    fresh interpreter, no card): each case's counts printed, every count
    positive, collectives in every case and no process group left."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"CASES = {list(DRYRUN_CASES)!r}\n" + _DRYRUN_COUNT],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600)
    check(proc.returncode == 0,
          f"dryrun_path: the count failed: {proc.stderr[-2000:]}")
    counted = json.loads(proc.stdout.strip().splitlines()[-1])
    for case in counted["cases"]:
        name = f"dryrun_path: {case['arch']} {case['mode']}"
        check(case["flops_per_chip"] > 0 and case["bytes_per_chip"] > 0
              and case["peak_bytes_per_chip"] > 0, f"{name}: empty count")
        check(sum(case["collectives"].values()) > 0,
              f"{name}: no collective")
        check(not case["group_left"], f"{name}: a process group was left")
    record = dict(phase="dryrun_path", torch=counted["torch"],
                  cases=counted["cases"],
                  phase_s=time.perf_counter() - t0)
    emit(**record)
    return record


def whisper_config():
    """whisper-medium as published in the reference: full width and
    depth, 24 encoder layers over 1,500 frames, 24 decoder layers."""
    from repro_torch.configs import get_config
    return get_config("whisper-medium")


def gemma3_config():
    """gemma3-27b at full width, depth cut to one published period: five
    local layers of window 1,024, then one global layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    cfg = get_config("gemma3-27b")
    return dataclasses.replace(cfg, n_layers=6,
                               stages=(Stage(cfg.stages[0].pattern, 1),))


def mla_config():
    """deepseek-v2-236b at full width, depth cut to its dense prologue
    layer and one MoE layer (160 experts top-6, 2 shared), both MLA."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    cfg = get_config("deepseek-v2-236b")
    return dataclasses.replace(cfg, n_layers=2, stages=tuple(
        Stage(st.pattern, 1) for st in cfg.stages))


def mla_prologue_config():
    """deepseek-v2-236b's dense prologue alone: MLA and a dense FFN."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-236b")
    return dataclasses.replace(cfg, n_layers=1, stages=cfg.stages[:1])


def mrope_config():
    """qwen2-vl-72b at full width, depth cut to one layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import Stage
    cfg = get_config("qwen2-vl-72b")
    return dataclasses.replace(cfg, n_layers=1,
                               stages=(Stage(cfg.stages[0].pattern, 1),))


def gemma2_config():
    """gemma2-2b as published: 26 layers, 13 x (local 4,096, global)."""
    from repro_torch.configs import get_config
    return get_config("gemma2-2b")


def qwen2_config():
    """qwen2-7b as published: 28 layers, QKV biases, GQA 28 over 4."""
    from repro_torch.configs import get_config
    return get_config("qwen2-7b")


def qwen2_train_config():
    """qwen2-7b at full width, depth cut to QWEN2_TRAIN_LAYERS layers."""
    import dataclasses
    from repro_torch.configs.base import Stage
    cfg = qwen2_config()
    return dataclasses.replace(cfg, n_layers=QWEN2_TRAIN_LAYERS, stages=(
        Stage(cfg.stages[0].pattern, QWEN2_TRAIN_LAYERS),))


def lm_config():
    """internlm2-1.8b at full width, depth cut to 4 of 24 layers."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec, Stage
    return dataclasses.replace(get_config("internlm2-1.8b"), n_layers=4,
                               stages=(Stage((LayerSpec(kind="attn",
                                                        ffn="dense"),), 4),))


def hybrid_config():
    """jamba-v0.1-52b at full width, depth cut to its two dense-FFN block
    kinds: one Mamba layer and one attention layer (its MoE layers at odd
    indices are ``hybrid_moe_config``'s)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec, Stage
    return dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=2,
                               stages=(Stage((
                                   LayerSpec(kind="mamba", ffn="dense"),
                                   LayerSpec(kind="attn", ffn="dense")), 1),))


def hybrid_moe_config():
    """jamba-v0.1-52b at full width, depth cut to layers 4 and 5 of its
    published period: ``(attn, dense)`` and ``(mamba, moe)`` (16 experts,
    top-2, d_expert 14,336, capacity factor 1.25).  The MoE layer is the
    last block before the final norm, whose output the Eq. 3 signature
    reads, so it decides tip selection."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerSpec, Stage
    return dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=2,
                               stages=(Stage((
                                   LayerSpec(kind="attn", ffn="dense"),
                                   LayerSpec(kind="mamba", ffn="moe")), 1),))


def xlstm_config():
    """xlstm-125m at full width and depth: [mLSTM x3, sLSTM] x3."""
    from repro_torch.configs import get_config
    return get_config("xlstm-125m")


def xlstm_loop_config():
    """xlstm-125m at full width, depth cut to one published period,
    [mLSTM x3, sLSTM]: the xLSTM loop and cohort paths, whose training
    (under remat) replays the sLSTM step loop on the host."""
    import dataclasses
    from repro_torch.configs.base import Stage
    cfg = xlstm_config()
    return dataclasses.replace(cfg, n_layers=len(cfg.stages[0].pattern),
                               stages=(Stage(cfg.stages[0].pattern, 1),))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from repro_torch import runtime
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import signature as sig
    from repro_torch.kernels import slstm as sl

    dev = runtime.resolve_device("cuda")
    smi = phase_environment(build)
    phase_build(build)
    sig_record = phase_kernels(sig, ops, dev)
    sig_record["widths"] += phase_signature_lm(sig, ops, dev)
    flash_record = phase_flash(fa, ops, dev)
    scan_record = phase_scan(ss, ops, dev)
    mlstm_record = phase_mlstm(ml, ops, dev)
    slstm_record = phase_slstm(sl, ops, dev)
    kern = {"sig": sig, "fa": fa, "ss": ss, "ml": ml, "sl": sl}
    cnn = phase_main_path(kern, dev)
    cohort = phase_cohort_path(kern, dev, cnn["s_per_round"])
    baselines = phase_baselines_path(kern, dev)
    scenarios = phase_scenarios_path(kern, dev)
    lm = phase_lm_loop(kern, dev, phase="lm_path", cfg=lm_config(),
                       clients=4, local_steps=8,
                       expected_params=630_736_896)
    hybrid = phase_lm_loop(kern, dev, phase="hybrid_path",
                           cfg=hybrid_config(), clients=3, local_steps=2,
                           expected_params=HYBRID_PARAMS)
    # the xLSTM stack's bfloat16 layers carry the one-ulp rounding
    # flips that the kernels' float32 h and the plain version's cause in
    # each layer's bfloat16 output on to the logits, past LM_LOGIT_RTOL;
    # with float32 products the two forwards differ only in float32
    # rounding: the check is made there, and the bfloat16 comparison is
    # reported beside it (PERF.md)
    xl = phase_lm_loop(kern, dev, phase="xlstm_path",
                       cfg=xlstm_loop_config(), clients=3, local_steps=2,
                       expected_params=XLSTM_LOOP_PARAMS,
                       reference_compute="float32")
    cohorts = phase_lm_cohort_path(kern, dev, {"lm": lm, "hybrid": hybrid,
                                               "xlstm": xl})
    train = phase_train_path(kern, dev)
    serve = phase_serve_path(kern, dev)
    serving = phase_serving_path(kern, dev, cnn["sim_time"],
                                 lm["sim_time"])
    moe = phase_moe_path(kern, dev)
    variants = phase_attention_variants_path(kern, dev)
    whisper = phase_whisper_path(kern, dev)
    mesh = phase_mesh_path(kern, dev)
    dense = phase_dense_configs_path(kern, dev)
    phase_dryrun_path()
    paths = {"lm": lm, "hybrid": hybrid, "xlstm": xl, **cohorts, **serve,
             **serving, **moe, **variants, **whisper, **mesh, **dense}
    records = {"signature": sig_record, "flash": flash_record,
               "scan": scan_record, "mlstm": mlstm_record,
               "slstm": slstm_record}
    for key, record in records.items():
        by_path = ({"cnn": cnn["signature"],
                    "cnn_cohort": cohort["signature"],
                    "cnn_baselines": baselines["signature"],
                    "cnn_scenarios": scenarios["signature"]}
                   if key == "signature" else {})
        by_path.update({name: p["launches"][key] for name, p in paths.items()
                        if p["launches"][key]})
        if key == "signature":
            by_path["lm_train"] = train["launches"]["signature"]
        record["launches_by_path"] = by_path
        record["launches"] = sum(by_path.values())
    sig_record["launches_by_route"] = {
        "cnn": cnn["signature_routes"],
        "cnn_cohort": cohort["signature_routes"],
        "cnn_baselines": baselines["signature_routes"],
        "cnn_scenarios": scenarios["signature_routes"],
        **{name: p["signature_routes"] for name, p in paths.items()},
        "lm_train": train["signature_routes"]}
    flash_record["launches_by_route"] = {
        name: p["flash_routes"] for name, p in paths.items()
        if p["launches"]["flash"]}
    # the variants' shapes: gemma3's launches by the window they ran at
    # (each leg gates them against its layers), MLA's every launch
    for row, legs, window in (("gemma3_local", "gemma3_", 1024),
                              ("gemma3_global", "gemma3_", -1),
                              ("mla", "mla_", -1),
                              ("whisper", "whisper_", -1),
                              ("gemma2_local", "gemma2_", 4096),
                              ("gemma2_global", "gemma2_", -1),
                              ("qwen2", "qwen2_", -1)):
        flash_record[row]["launches"] = sum(
            p["flash_windows"].get(window, 0) for name, p in paths.items()
            if name.startswith(legs))
    for width in sig_record["widths"]:
        # every CNN path signs at the CNN width, the MoE legs at Jamba's
        prefixes = (width["path"],) + (("moe",) if width["path"] == "hybrid"
                                       else ())
        width["launches"] = sum(
            n for name, n in sig_record["launches_by_path"].items()
            if any(name == pre or name.startswith(pre + "_")
                   for pre in prefixes))
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
