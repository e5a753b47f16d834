#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (legommenders_tpu_torch) on one card.

Run from the root of a checkout: `python3 chip_smoke.py` runs every phase;
`python3 chip_smoke.py --phases 3,11` runs the device, the build, the data
and those phases only (for iterating on them). It needs one CUDA card and
nvcc (on PATH, or under CUDA_HOME), imports nothing of JAX, prints a
`[phase]` line with the wall seconds of each phase (the build and the
host data build too, and the share of the profiler's host-side summaries)
and exits non-zero when any phase fails:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for the parity phases;
  2. build: compiles csrc/additive_pool.cu and csrc/packed_attention.cu
     with nvcc, one process each, both at once, and prints the build
     seconds and ptxas' register/spill report;
  3. kernels vs plain versions, each at the shapes its main path gives it,
     in f32 (within 1e-5 absolute) and bf16 (within 2e-2 of the largest
     output of the plain version computed from the same bf16 inputs),
     timed with CUDA events (the calls enqueued behind a sleep kernel, so
     that the host's pace does not set a short kernel's time) beside the
     card's least possible time (bound):
     - the additive pool at both NAML widths (item pool 65,000 x 31 x 64,
       user pool 20,000 x 50 x 64, H = 256) and at one page of 512 items
       or users at each length the main paths pool (L = 31, 34, 40, 50),
       with partly and fully masked rows; all-masked rows must give
       exactly 0; bf16 goes to additive_pool_tc, f32 to
       additive_pool_kernel (3xTF32); the bound counts the N*L*H tanh at
       the special-function units' rate beside the products (f32 at
       3xTF32's 165 TFLOP/s, the CUDA cores' 67 beside it) and the bytes;
       then the tile kernels at their edges (check_pool_edges:
       additive_pool_long at L 129-4,096 over N 1, 7, 131 and 600, both at
       D 4 / 20 / 100 and H 1 / 33 / 100 / 300), each call made twice and
       the two outputs bit-equal;
     - the packed attention forward at bert-naml's serving page (171
       packed rows of 3 items x 34 tokens = 102, D = 768, 12 heads), with
       the block-diagonal biases packed_mask_bias makes from random title
       lengths;
     - at the training page (171 rows of 3 items x 40 tokens = 120: the
       cached hidden states are padded to 40) at dropout 0.1 and 0: the
       forward against the plain version given the mask kernel's mask,
       the backward (dq, dk, dv) against the plain backward with the same
       mask, the mask kernel against the plain Philox (exactly), the keep
       fraction within 4 sigma of 0.9, the same seed giving the same mask
       and another seed another;
     in both types (f32 on the 3xTF32 tensor-core kernels, whose bound
     is taken at 495 / 3 TFLOP/s with the CUDA cores' 67 beside it);
     torch's scaled_dot_product_attention (forward, and forward + backward
     with the float mask and the dropout) in the same type is timed beside
     them as the yardstick (library_ms) and is never called by the port;
  4. serving paths, each through Manager + Tester.test() at full width on
     one synthetic MIND-small-geometry fixture (65,000 items, 20,000 users,
     title 30, history 50, vocab 30,000), random weights from seed 0, bf16;
     every launch count is set to 0 just before a path and read just after
     (every profiled pool launch of a main path must be the tensor-core
     kernel's):
     - NAML (CNN / Ada / Dot, hidden 64): the pool launches once per item
       page + user page, the attention never;
     - bert-naml (BertBase / Ada / Dot, item-bert.yaml's defaults: 12
       layers, d 768, 12 heads, LoRA r 32 folded, fused attention, tanh
       gelu, [CLS] title [SEP] category [SEP] compacted, pages of 512): the
       attention launches 12 times per item page, the pool once per item
       page + user page.
     The first 2,048 item and user reprs are held against the same model
     with every kernel patched out for its plain version, on the card, and
     the device metrics against the numpy MetricPool on the same scores.
     One more warm pass of each runs under torch.profiler for device time
     by kernel and the device's idle share; in every profiled window each
     port kernel's profiled launches must equal its wrapper's count, less
     only launches whose device record the trace shows the tracer lost;
  5. training paths on the same fixture, bf16, Adam (lr 1e-4), batches of
     2,048 impressions (1 positive + 4 negatives) assembled on the device
     by DeviceTrainPipeline; launch counts set to 0 before the timed steps:
     - bert-naml layer-split (tune_from 10: layers 0-9 cached once on the
       device, 1,270 attention launches; layers 10-11 trained with LoRA
       r 32 folded, hidden and attention dropout 0.1 through
       SharedBitsDropout and the kernel, the 65,000-item catalog encoded
       every step in 127 pages of 512 under the `ffn` remat policy,
       bench_lm.py's): per step 508 attention forwards, 254 backwards and
       255 pools; 1 warm and 5 timed steps, each to the device's end of it
       (finite losses, median step ms, impressions/s, peak memory), one
       more under torch.profiler; the same weights and batches under
       `full` remat (2 timed steps, one profiled: step ms, peak memory,
       the profiled matrix-product launches of each policy; the losses
       the two runs share within 2e-2 of each other); then the gradient
       of every trainable tensor on one batch at dropout 0 (lora_B made
       non-zero), through the kernels and with every kernel patched out
       for its plain version (plain forward and plain backward), at bf16
       and, with the same weights, at f32: at f32 the kernels' within 2e-2
       of each tensor's largest plain gradient; at bf16 within 2e-2, or
       within half the plain path's own bf16-vs-f32 error where that is
       larger (see precision_check), and by the same rule under `ffn`
       against `full` remat; and the bf16 cache built through the kernel
       and through the plain unfused attention, each against the f32
       cache;
     - NAML: 1 warm and 3 timed steps, 2 pool launches per step, the
       catalog-grad plans live;
  6. the run loop on the same fixture, bf16, through the entry points a
     user calls (each path's launch counts set to 0 just before it, read
     just after and held against the count the code gives):
     1. NAML through Trainer.train() + test() on host batches (TrainBatcher
        with the C negative sampler, a Prefetcher moving batches to the
        card): batches of 2,048, 2 epochs of 8 steps, 4 warmup updates,
        dev through the caches each epoch, the best checkpoint saved and
        reloaded (bit for bit what was saved, scoring as the in-memory
        copy does); step ms (median after the first step, each step timed
        to the card's end of it), impressions/s, the share of the loop
        spent waiting for batches, checkpoint bytes and save/load seconds;
     2. the same Trainer on device batches (`device_batching`), 8 steps;
     3. the trained model's test phase by full forwards (pages of the eval
        batch, 8,192, each encoding the catalog and pooling its users),
        beside the cached Tester.test(): the first 2,048 scores within
        1e-2 of the cached path's largest score, the metrics within 1e-3;
     4. Tester.latency over 20 eval batches, cached and by full forwards;
     5. bert-naml layer-split through the Trainer with item_lr (the LoRA
        of the upper slice alone in the item LR group), 2 steps of 2,048,
        dev through the caches;
     6. the CLI (python -m legommenders_tpu_torch.process / .trainer at
        `make smoke`'s geometry, NAML and LSTUR) on the card, where PyYAML
        is installed;
  7. the news zoo and the catalog gradient plans, on the same fixture:
     1. the pool kernel against its plain version (f32 and bf16) at each
        zoo pool shape (ZOO_POOLS: L 1, 30 and 33 at H 256, L 31 and 50 at
        H 64), at the full catalog or user count and at a page of 512;
     2. NRMS, LSTUR, Fastformer and MINER, each built from its
        config/model YAML at its defaults (hidden 64, 8 heads, 3 layers,
        32 context codes of 200, 4 negatives), bf16: Tester.test()
        (through the caches; MINER, whose user operator refuses caching,
        by full forwards, a catalog encode a page of 8,192), the first
        2,048 served item reprs against the same model with its kernels
        patched out (2e-2), 1 warm and 4 fused training steps of 2,048
        (median step ms, impressions/s, peak memory; one more profiled);
        every pool launch held against the count the modules give
        (AdditiveAttention modules per encode x encodes) and the catalog
        gradient plans live in the steps (catalog_grad.last_trace);
     3. NAML's gradients on one batch with the plans and without them
        (catalog_plans and catalog_history_plan None), at f32 within 1e-5
        of each tensor's largest value and at bf16 within 2e-2 (a bias
        against the larger of its own and its weight's: a pool's
        proj_bias gradient is cancellation residue); then the bf16 step
        both ways, 3 timed steps each and one profiled;
  8. the CTR zoo (ranking mode, the id-only item path, the Pooling and
     null operators), on the same fixture, bf16, random weights from seed
     0:
     1. the pool kernel against its plain version (f32 and bf16) at the
        user pools of the steps and test pages (CTR_POOLS): the id models'
        Ada pool, L 50, D 64, H 256 over a training step's 2,048 users and
        a full-forward test page's 8,192; bst_text's Transformer pool,
        L 50, D 64, H 64 over a training step's 2,048 users;
     2. each of the 24 YAMLs (CTR_MODELS: the ten heads DNN, PNN, DeepFM,
        DCN, DCNv2, GDCN, AutoInt, MaskNet, FinalMLP and DIN, each _id and
        _text; naml_id, nrms_id, miner_id, bst_text) at its defaults
        (hidden 64, MLPs of [1000, 1000, 1000], cross_num 3, DCNv2
        stacked_parallel with the low-rank mixture r 32 of 4 experts,
        AutoInt 3 layers of 8 heads at 64, MaskNet 1 block of 64, DIN
        attention units [64] with Dice): Tester.test() on the 240,000 test
        rows (through the caches where both operators allow them, else by
        full forwards, pages of 8,192), 1 warm and 4 fused training steps
        of 2,048 (median step ms, impressions/s, peak memory, the device's
        idle share from one more profiled step); every pool launch held
        against the count the modules give (one a test page or cache page
        and one a step for an Ada or Attention user, none for a Pooling or
        null user); the 240,000 test scores of each model that pools
        (the _id models but din_id, bst_text) against the same model with
        its kernels patched out (2e-2 of the largest; bst_text's caches
        rebuilt without them); one `[ctr]` line each;
     3. the CLI trains dcn_id and din_text (`make smoke`'s geometry) on the
        card, as 6.6 does NAML and LSTUR;
  9. the decoder LMs, on the same fixture, bf16, random weights from seed
     0 drawn on the card:
     1. the attention forward (and at a training page the backward) at
        dropout 0 against the plain versions (f32 1e-5, the f32 backward
        at the training page timed beside its bound, and at dh 128 at
        T 116 and 117 with and without dropout; bf16 2e-2 of the
        largest), at the decoder pages (DECODER_PAGES: 512 items of
        the compact title + category, L 31, 4 to a row, T 124, serving;
        the cache's L 32, T 128, training; 128 rows; Llama / GLM 32 heads
        of 128, OPT 12 of 64) with the causal packed biases of random
        lengths, timed beside the plain versions, SDPA with the float mask
        and the bounds;
     2. llama-naml at the Llama-7B geometry (32 layers, d 4096, 32 heads,
        SwiGLU 10,922, LoRA r 32 folded, fused attention): Tester.test()
        in full-LM mode cut to 2 layers (all 65,000 items through them;
        the first 2,048 reprs against the model with its kernels patched
        out, 2e-2;
        8 pages profiled; peak memory); then layer-split, cut to 4 layers
        at tune_from 2:
        the cache, 1 warm and 2 timed fused steps of 2,048 under `full`
        remat (one more profiled) and the trainable slice's gradients
        against the plain path at bf16 and at f32 (decoder_precision_check);
     3. glm-naml at GLM's full width cut to 4 layers at tune_from 2, and
        opt-naml (OPTBase, 12 layers) at tune_from 10 with hidden dropout
        0.1: the cache, Tester.test() through the caches (reprs against
        the plain path), 2 timed steps;
     every launch count held against the code's; `[decoder]` lines;
 10. IISAN, the BERT zoo and the flatten user paths, on the same fixture,
     bf16, random weights from seed 0:
     1. the long-sequence pool (additive_pool_long) against its plain
        version (f32 and bf16) at the flatten user pools (FLATTEN_POOLS:
        L 1,023 and 495, D 64, H 64) over a step's users and a test page;
     2. bert-iisan-naml at its YAML's defaults (BERT-base, selected layers
        1, 3, ..., 11) and llama-iisan-naml at the Llama-7B width cut to 4
        layers: the IISAN cache over all 65,000 items (the attention
        launched once a layer a page; its states against the plain
        attention's, 2e-2), Tester.test() through the caches (the served
        reprs against the patched-out model, 2e-2), 4 fused steps of 2,048
        (the user pool only); bert-iisan-naml through one Trainer run;
     3. bert-nrms, -lstur, -miner, -fastformer and -dcn layer-split at
        tune_from 10: the cache, Tester.test() (MINER by full forwards),
        2 fused steps of 2,048;
     4. flatten_transformer and flatten_fastformer at their defaults over
        the fixture's histories cut to 31 and 15 clicks (L 1,023 and 495,
        the positions their user operators have): Tester.test() by full
        forwards at the largest eval batch that fits, two pages' scores
        against the patched-out model (2e-2), 4 fused steps at the largest
        batch that fits; peak memory;
     5. the CLI trains bert-iisan-naml and flatten_transformer;
     every launch count held against the code's; `[iisan]`, `[bert-zoo]`
     and `[flatten]` lines;
 11. the LM knobs, the semantic-ID family and processed MIND, bf16, random
     weights from seed 0:
     1. bert-naml layer-split as phase 5 trains it, on a catalog of 16,384
        items (DOTS_DATA_KW: `dots` keeps ~72 GB at 65,000): the same
        weights and batches under `full`, `dots`, `full` with fused_qkv
        and `full` with norm_bf16, 2 timed steps and one profiled each
        (step ms, peak memory, idle share, matrix-product launches,
        launches a step = the code's, the losses each shares with `full`
        within 2e-2); the gradients on one batch at dropout 0 with each
        knob against the knob off under `full` (knob_grad_check: fused_qkv
        at f32 within 1e-4 of each tensor's largest, fused_qkv and `dots`
        at bf16 by precision_check's rule; norm_bf16 against f32 within 3
        times the knob-off bf16 path's error); one page of 512 items
        through glm-naml cut to 4 layers with fused_qkv off and on (GQA,
        qkv biases) and through llama-naml cut to 2 layers with norm_bf16
        off and on: the item vectors within 2e-2 of the largest, each side
        timed;
     2. the semantic family on the fixture with 4 codes an item and a
        user from codebooks of 256 (semantic_data; TIGER's shape): the
        pool at L 4 over the 65,000 items against its plain version; Ada /
        Semantic (return_stack) / Poly, Ada / Semantic / Dot and SCSimple /
        SCMix / SemanticMix: Tester.test() by full forwards over the
        240,000 test rows, 4 fused steps of 2,048, the pool's launches a
        page and a step against the modules' count;
     3. a fake MIND raw layout at `make smoke`'s geometry, `process --data
        mind --tokenizers glove:<file>`, NAML trained and tested through
        the CLI on the processed stores;
     `[knobs]` and `[semantic]` lines;
 12. the offline drivers, the worker and the dp axis, bf16, random weights
     from seed 0 (`[drivers]` lines), each in a temporary directory:
     1. NAML's Trainer (2 steps of 2,048, a dev pass) writes its best
        checkpoint; `extractor.extract` loads it into a Manager of another
        seed and exports the repr caches (65,000 x 64 items, 20,000
        users): equal to Tester's cache on the trained weights bit for
        bit, one pool launch a cache page (167);
     2. the splitter (`--layers -2`, which wraps to 10) writes bert-naml's
        lower-slice cache over the 16,384-item catalog (32 pages: 320
        attention launches; its bytes printed); a bert-naml Trainer
        reading it launches no lower-slice attention in its init, one
        building it in memory launches 320; each takes a step and a dev
        pass from the same weights (the steps `deterministic`): caches and
        losses equal bit for bit, repr caches within 1e-3 of the largest;
        3. the sizer's count at full width;
     4. an HF-layout BERT checkpoint (a random 30,522 x 768 table) through
        `embed --model bertbase`: the exported table equals it; a NAML
        Manager given the exported config holds it frozen and serves;
     5. the worker runs one small NAML job over 2 seeds (trainer processes
        on the card, each under a timeout) against a lego-server stub on a
        local thread: each seed registered and completed with its metrics
        as JSON; a second run skips both;
     6. NAML through the Trainer, 5 host batches of 16,384 (5 epochs of
        one step and a dev pass), plain and under `exp.policy.mesh: true`
        in an NCCL group of one, both `deterministic`: losses, weights and
        dev values equal bit for bit, the same launches (the pool 2 a step, one a cache page),
        both step times; the group destroyed;
 13. the model-parallel axis and catalog_parallel on the 16,384-item
     catalog (DOTS_DATA_KW, for the time limit; the TP cases on 2,048
     items, P13_SMALL_DATA_KW, since PR 15's phase 14), bf16, random
     weights from seed 0: two rank processes (`p13_rank`, started by
     parallel/launch.py) share the card over gloo (NCCL refuses two ranks
     on one device; gloo's all-gathers go through host memory, the model,
     the kernels and the optimizer stay on the card) while this process
     runs each case in one process from the same weights and batches;
     each case is Manager + Trainer.train(), one step of 2,048 on device
     batches and a dev pass through the caches, `deterministic`, every
     launch count set to 0 just before and read just after, in each
     process:
     - bert-naml (phase 5's layer-split training, hidden and attention
       dropout 0.1) at mp 2: Megatron TP of the upper slice, 6 heads a
       rank, the attention kernels at head offset 0 and 6; the best
       checkpoint written as the sharded directory;
     - the same at f32 (its LM too): TP's own error, apart from
       bf16's;
     - dcnv2_id at its YAML (CrossNetMix, 4 experts: 2 a rank) at mp 2;
     - NAML at mp 2 with its tables row-sharded (min_rows_to_shard 0: the
       30,000-word table 15,000 rows a rank);
     - bert-naml catalog_parallel (dropout 0: the ranks' encode masks
       differ by construction), each rank holding 8,192 rows of the
       layer-split cache, then Trainer.test();
     the gathered gradients and the loss within 2e-2 of one process's
     (of each tensor's largest, a bias's against the larger of its own
     and its weight's, as phase 7.3 holds them; the f32 case within
     F32_GRAD_TOL; bf16 bert-naml's TP gradients within 2e-2 or within
     one process's own bf16 error against its f32 run where larger,
     `_p13_bf16_rule`), each parameter's update (after less before)
     within 2e-2 of lr of one process's on every element whose gradient
     lies beyond its gradient's gate of zero and beyond 50 Adam eps
     (`_p13_update_errs`: a skipped or doubled step reads 1, a flipped
     one 2), the dev value and the test metrics within 2e-2; each rank's
     keep mask at its head offset equal to the 12-head mask's slice
     exactly; the attention forward and backward at half the heads and
     their offset (bert-naml's training page, bf16 and f32; the Llama
     training page, bf16; dropout 0.1) equal to the whole page's call's
     head slice bit for bit and to their plain versions at the kernels'
     gates (`p13_attention_offsets`); the sharded checkpoint read in one
     process equal to the gathered weights bit for bit; `[mp]` lines.
 14. the sequence-parallel and pipeline-parallel axes (`p14_rank`,
     two ranks over gloo, phase 13's checks): flatten_transformer at sp 2
     under Ulysses and ring (bf16, and Ulysses at f32), flatten_fastformer
     at sp 2, bert-naml and a Llama-7B-width slice at pp 2; `[sp]` and
     `[pp]` lines.
 15. the mesh combinations and the catalog-parallel evaluation on 2,048
     items (P13_SMALL_DATA_KW), bf16, dropout 0, the dev and test rows of
     the first P15_USERS users (`p15_rank`): four ranks over gloo
     run bert-naml at (mp 2, pp 2) (Megatron TP inside each GPipe stage:
     the attention kernels at head offset 0 or 6, counted by offset),
     flatten_transformer at (mp 2, sp 2) under Ulysses (its tables
     row-sharded) and flatten_transformer's sequence-parallel user
     operator beside a 2-layer BERT item operator at (sp 2, pp 2); two
     more ranks at the same time run bert-naml catalog_parallel at dp 2,
     its dev value by simple_dev and Trainer.test() by full forwards over
     the reprs each rank encodes of its rows; each case is held against
     one process from the same weights and batches by phase 13's checks
     in every (dp, sp, pp) cell, and each rank's launches against the
     count the code gives (`_p15_expected`); `[mesh15]` lines.
 16. the scaling sweep and the multi-chip dry run (the port's scaling.py
     and graft.dryrun_multichip, four ranks sharing the card over gloo
     through parallel/launch.py, f32): the pool at the phase's shapes and
     both attention kernels at head width 8 (T 6, 9 and 126) against
     their plain versions; dryrun_multichip(4): the NRMS Trainer at (dp 2,
     mp 2) and at catalog_parallel 4, a 2-layer BERT Trainer at (dp 2, pp
     2) against the same run in this process (GAUC within 5e-3), the sp
     pool against one process's, then sweep(n=4) (dp 1, 2, 4, (2, 2), sp
     4, pp 2, catalog_parallel 4; its step-equivalence asserts; each
     point's collective bytes); NRMS at its YAML's width (hidden 64, 8
     heads, attention dropout 0) on DATA_KW at dp 4 and (dp 2, mp 2),
     batches of TRAIN_BATCH, P16_STEPS steps, within the sweep's rtol of
     one process from the same weights; each rank's launches against the
     count the code gives (`_p16_point_expected`,
     `_p16_trainer_expected`); `[scaling]` lines.
Then it prints one JSON line of kernels, the card line, and
{"ok": true, "device": {...}} as the last line.
"""
import bisect
import collections
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM data-sheet peaks (dense): bf16 and TF32 on the tensor
# cores, f32 on the CUDA cores; the f32 attention and pool kernels take
# three TF32 products for each f32 one (3xTF32), an effective 495 / 3
# TFLOP/s
PEAK = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# 132 SMs at 1.98 GHz (H100 SXM boost)
SMS, SM_HZ = 132, 1.98e9
# tanh.approx.f32: 16 special-function results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0)
TANH_PER_S = 16 * SMS * SM_HZ
# Integer instructions one SM issues per clock, measured on an NVIDIA H100
# 80GB HBM3 at 700 W (SM clock 1.98 GHz throughout) by
# legommenders_tpu_torch/tools/int_rates.py: LOP3 63.6 and IMAD 64.0 (the
# guide's 64 for 32-bit integer operations), LOP3 + ISETP together 60.4,
# and IMAD.WIDE.U32 (32 x 32 -> 64-bit) 31.7 beside as many LOP3: it
# takes two of the FMA pipe's 64 slots, so the FMA pipe's rate for the
# Philox products is 32, half the guide's multiply-add rate. mask_bound
# lets the two pipes run side by side; mixed as in a draw (IMAD.WIDE.U32
# beside two LOP3) they issue 2 warp instructions a clock per SM together,
# the products at 21: the bound is the lower of the two readings.
ALU_PER_CLK = 64
IMAD_WIDE_PER_CLK = 32
# Philox4x32-10 at counter (jp, i, h, b) (column pair, row with bit 3
# clear, head, packed row): per round two IMAD.WIDE.U32 (32 x 32 -> 64) on
# the FMA pipe and two three-input XORs (LOP3) on the integer ALU. Each is
# needed once per distinct value of the counter words its input holds:
# rounds 0-2's products and rounds 0-1's XORs hold fewer than all four
# (tests/test_torch_build.py checks these sets against the Philox itself).
_ALL_WORDS = ("jp", "i", "h", "b")
PHILOX_PRODUCT_WORDS = (
    (("jp",), ("h",)), (("i", "h"), ("jp", "b")),
    (("jp", "b", "h"), ("jp", "i", "h"))) + ((_ALL_WORDS, _ALL_WORDS),) * 7
PHILOX_XOR_WORDS = (
    (("i", "h"), ("jp", "b")),
    (("jp", "b", "h"), ("jp", "i", "h"))) + ((_ALL_WORDS, _ALL_WORDS),) * 8
# Philox draws per unit of work of a dropout_mask thread (kMaskDraws) and
# the threads of its CTA (kMaskThreads)
MASK_DRAWS, MASK_THREADS = 4, 256

D, H = 64, 256
POOLS = {"item": (65000, 31), "user": (20000, 50)}
# one cache page (512 items or users) at each length the main paths pool:
# NAML items 31, bert-naml items 34 (serving) and 40 (training), users 50
PAGE_N, PAGE_LS = 512, (31, 34, 40, 50)
DATA_KW = dict(num_items=65000, num_users=20000, title_len=30, history_len=50,
               vocab_size=30000, inters_per_user=12)
MODEL_CFG = {
    "meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 64,
               "cache_page_size": 512,
               "item_config": {"dropout": 0.1, "kernel_size": 3}},
}
# config/model/bert-naml.yaml with common/operators/item-bert.yaml's
# defaults as written (BertBase: 12 layers, 12 heads, d 768)
BERT_CFG = {
    "meta": {"item": "BertBase", "user": "Ada", "predictor": "Dot"},
    "config": {"use_item_content": True, "hidden_size": 64,
               "embedding_dim": 768, "cache_page_size": 512,
               "item_config": {
                   "lm_dtype": "bf16", "tune_from": None, "use_lora": True,
                   "lora_r": 32, "fused_attention": True,
                   "gelu_approximate": True, "lora_dropout": 0.0,
                   "lora_fold": True, "dropout_reuse": True,
                   "inputer_config": {"use_cls_token": True,
                                      "use_sep_token": True,
                                      "compact": True}}},
}
BERT_LAYERS = 12
# layer-split training: bench_lm.py's configuration (tune_from 10, pages
# of 512 under the `ffn` remat policy, 4 negatives) with item-bert.yaml's
# dropout defaults (hidden and attention 0.1, dropout_reuse)
BERT_TRAIN_CFG = {
    "meta": BERT_CFG["meta"],
    "config": {**BERT_CFG["config"], "use_fast_eval": False,
               "neg_count": 4, "item_page_size": 512,
               "item_page_remat": "ffn", "full_catalog_encode": "auto",
               "item_config": {**BERT_CFG["config"]["item_config"],
                               "tune_from": 10}},
}
TRAIN_BATCH, TRAIN_LR, LM_STEPS, NAML_STEPS = 2048, 1e-4, 5, 3
# timed steps of each side of a remat or knob A/B (phases 5 and 11)
AB_STEPS = 2
# bert-naml's attention pages: 512 items of L = 1 + 30 + 1 + 1 + 1 = 34
# tokens (serving) or of the cached 34 padded to L = 40 (training), packed
# G = 128 // L = 3 to a row: 171 rows of T = 102 or 120
ATTN_PAGE = dict(items=512, L=34, D=768, heads=12)
TRAIN_PAGE = dict(items=512, L=40, D=768, heads=12)
TRAIN_DROPOUT = 0.1
EXP_CFG = {"policy": {"dtype": "bf16"}}
F32_TOL, BF16_REL_TOL = 1e-5, 2e-2
# a decoder's gradient through the kernels at f32 against the plain path's,
# over each tensor's largest value (the sums run in another order)
F32_GRAD_TOL = 1e-4
# a sleep kernel of this many cycles (~10 ms) ahead of each timed loop
HEAD_START_CYCLES = 20_000_000
REPR_ROWS = 2048


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device ms per call of fn, timed with CUDA events over `iters` calls
    enqueued behind a sleep kernel: a kernel shorter than the host's cost
    of enqueuing it would otherwise be timed at the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def product_peak(dtype_name: str) -> str:
    """The PEAK key of the products of the port's kernels in dtype_name:
    the f32 kernels run their products in 3xTF32 on the tensor cores."""
    return "tf32x3" if dtype_name == "f32" else dtype_name


def roof(flops: float, nbytes: float, dtype: str):
    """(ms, 'bytes'|'operations') the card needs at least for this work:
    the larger of the bytes over the memory rate and the operations over
    the data-sheet peak for dtype."""
    t_ops, t_bytes = flops / PEAK[dtype], nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound(N: int, L: int, dtype: str, h: int = H, d: int = D,
          peak: str = ""):
    """The additive pool's bound at width d and hidden width h: inputs
    read once, output written once; its operations are the products at
    the tensor cores' peak for dtype (f32 in 3xTF32, product_peak; `peak`
    names another PEAK key) and the N*L*h tanh at the special-function
    units' rate, which run on separate units: the longest of the three."""
    xb = 2 if dtype == "bf16" else 4
    flops = 2.0 * N * L * (d * h + h + d)
    nbytes = N * L * d * xb + N * L * 4 + (d * h + 2 * h) * 4 + N * d * xb
    ms, by = roof(flops, nbytes, peak or product_peak(dtype))
    tanh_ms = N * L * h / TANH_PER_S * 1e3
    return (ms, by) if ms >= tanh_ms else (tanh_ms, "operations")


def philox_rows(T: int) -> int:
    """The rows i < T with bit 3 clear: each draw gives rows i and i + 8."""
    return (T >> 4) * 8 + min(T & 15, 8)


def philox_draws(T: int) -> int:
    """The Philox draws that cover (i, j) in [0, T)^2 for one (b, h): each
    gives the words of rows i and i + 8 for i with bit 3 clear, and of
    columns j and j + 1 for even j."""
    return philox_rows(T) * ((T + 1) // 2)


def philox_ops(B: int, heads: int, T: int):
    """(products, XORs) the draws of a (B, heads, T, T) mask need: each of
    PHILOX_PRODUCT_WORDS / PHILOX_XOR_WORDS once per distinct value of the
    counter words it holds."""
    size = {"jp": (T + 1) // 2, "i": philox_rows(T), "h": heads, "b": B}

    def count(table):
        return sum(math.prod(size[w] for w in words)
                   for rnd in table for words in rnd)

    return count(PHILOX_PRODUCT_WORDS), count(PHILOX_XOR_WORDS)


def mask_bound(B: int, heads: int, T: int):
    """The keep mask's bound: one byte written per element, and the Philox
    draws' operations, the products on the FMA pipe and the XORs and one
    compare per element on the integer ALU, which run side by side, each at
    its measured rate: the longest of the three."""
    products, xors = philox_ops(B, heads, T)
    t_alu = (xors + B * heads * T * T) / (ALU_PER_CLK * SMS * SM_HZ)
    t_fma = products / (IMAD_WIDE_PER_CLK * SMS * SM_HZ)
    t_ops = max(t_alu, t_fma)
    t_bytes = B * heads * T * T / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mask_shape(page: dict):
    """(B, heads, T) of the keep mask of an attention page: its items
    packed G = 128 // L to a row."""
    G = 128 // page["L"]
    return -(-page["items"] // G), page["heads"], G * page["L"]


def mask_layout(T: int):
    """dropout_mask's launch arguments for T (csrc/packed_attention.cu
    keep_mask_launch): the column blocks n_cb of 2 MASK_DRAWS columns, the
    row groups n_gi (philox_rows) and the store width W, 8 when T is a
    multiple of 8, else 1."""
    return -(-T // (2 * MASK_DRAWS)), philox_rows(T), 8 if T % 8 == 0 else 1


def mask_units(T: int):
    """The units of work of one (b, h) item as dropout_mask's threads take
    them: thread t keeps column block c = t % n_cb (columns 2Dc..2Dc+2D-1,
    D = MASK_DRAWS) and takes row groups t // n_cb, + g_step, ... (rows
    i0 = 16 (gi >> 3) + (gi & 7) and i0 + 8), or, with n_cb >= the CTA's
    threads, blocks t, t + threads, ... and every row group; yields
    (t, i0, j0, nv), nv the bytes it stores in each row."""
    cols, n = 2 * MASK_DRAWS, MASK_THREADS
    n_cb, n_gi, _ = mask_layout(T)
    g_step, c_step = (n // n_cb, n_cb) if n_cb < n else (1, n)
    for t in range(n):
        g_first = t // n_cb if t // n_cb < g_step else n_gi
        for c in range(t % n_cb, n_cb, c_step):
            for gi in range(g_first, n_gi, g_step):
                i0 = (gi >> 3) << 4 | (gi & 7)
                yield t, i0, c * cols, min(cols, T - c * cols)


def pool_iters(N: int) -> int:
    """Calls per timing of the pool: fewer for the full pools than for a
    page, whose launch is ~100 times shorter."""
    return 20 if N > PAGE_N else 50


def pool_inputs(N, L, dtype, device, seed, h=H, d=D):
    """x ~ N(0, 1); mask with random holes, every 97th row fully masked and
    every 89th fully valid; weights at the model's init scale."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(N, L, d, generator=g, device=device).to(dtype)
    mask = (torch.rand(N, L, generator=g, device=device) < 0.8).float()
    mask[::97] = 0.0
    mask[1::89] = 1.0
    w1 = torch.randn(d, h, generator=g, device=device) / math.sqrt(d)
    b1 = torch.randn(h, generator=g, device=device) * 0.1
    w2 = torch.randn(h, generator=g, device=device) / math.sqrt(h)
    return x, mask, w1, b1, w2


def check_pool(pool: str, N: int, L: int, dtype_name: str, device,
               h: int = H, plain_iters: int = 5, d: int = D) -> dict:
    import torch
    from legommenders_tpu_torch.ops.additive import (
        additive_pool, additive_pool_reference, pool_kernel,
    )

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    args = pool_inputs(N, L, dtype, device, seed=L, h=h, d=d)
    x, mask = args[0], args[1]
    with torch.inference_mode():
        got = additive_pool(*args)
        want = additive_pool_reference(x.float(), *args[1:])
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        zero_rows = mask.sum(dim=1) == 0
        res = {"pool": pool, "N": N, "L": L, "D": d, "H": h,
               "dtype": dtype_name,
               "kernel": pool_kernel(dtype, L, d, h)[0],
               "max_abs_err": float(err.max()),
               "rel_err": float(err.max() / want.abs().max()),
               "all_masked_rows": int(zero_rows.sum()),
               "all_masked_exact_zero": bool((got[zero_rows] == 0).all()),
               "ms": time_ms(lambda: additive_pool(*args),
                              iters=pool_iters(N)),
               "plain_ms": time_ms(lambda: additive_pool_reference(*args),
                                   iters=plain_iters)}
    res["bound_ms"], res["bound_by"] = bound(N, L, dtype_name, h, d)
    peak = product_peak(dtype_name)
    res["bound_peak"] = f"{peak} {PEAK[peak] / 1e12:g} TFLOP/s"
    if dtype_name == "f32":
        # the bound with the products on the CUDA cores, beside it
        res["cuda_core_bound_ms"] = bound(N, L, dtype_name, h, d, "f32")[0]
    ok = (res["max_abs_err"] <= F32_TOL if dtype_name == "f32"
          else res["rel_err"] <= BF16_REL_TOL)
    if not (ok and res["all_masked_exact_zero"] and res["all_masked_rows"]):
        raise RuntimeError(f"additive_pool disagrees with its plain "
                           f"version: {res}")
    return res


# the tile kernels' edges (phase 3): additive_pool_long around its tiles
# of 128 positions, over N 1, 7 and 131 (an item spread over several CTAs)
# and 600 (on one CTA each) at D 64, H 64; both tile kernels at odd widths
# (additive_pool_kernel at L 13, additive_pool_long at 150)
POOL_EDGE_LS = (129, 255, 256, 257, 1024, 1025, 4096)
POOL_EDGE_NS = (1, 7, 131, 600)
POOL_ODD_DS, POOL_ODD_HS = (4, 20, 100), (1, 33, 100, 300)
POOL_ODD_LS, POOL_ODD_N = (13, 150), 37


def pool_edge_cases():
    """(N, L, D, H) of the tile kernels' edge checks (POOL_EDGE_*,
    POOL_ODD_*)."""
    return ([(n, L, D, 64) for L in POOL_EDGE_LS for n in POOL_EDGE_NS]
            + [(POOL_ODD_N, L, d, h) for L in POOL_ODD_LS
               for d in POOL_ODD_DS for h in POOL_ODD_HS])


def pool_edge_inputs(N, L, dtype, device, seed, h, d):
    """pool_inputs with the masks the tile edges need: item 0 all masked
    (where N > 1), item 1 valid only in its last tile of 128 positions,
    item 2 with its second tile all masked; the rest valid at random."""
    import torch

    x, mask, w1, b1, w2 = pool_inputs(N, L, dtype, device, seed, h=h, d=d)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    mask.copy_((torch.rand(N, L, generator=g, device=device) < 0.8).float())
    last = (L - 1) // 128 * 128
    if N > 1:
        mask[0] = 0.0
    if N > 2:
        mask[1, :last] = 0.0
        mask[1, last] = 1.0
    if N > 3 and L > 128:
        mask[2, 128:256] = 0.0
    return x, mask, w1, b1, w2


def check_pool_edges(device) -> dict:
    """The tile kernels (additive_pool_kernel, additive_pool_long) at
    pool_edge_cases, f32 and bf16, against the plain version (f32 within
    F32_TOL absolute, bf16 within BF16_REL_TOL of the largest), all-masked
    items exactly 0, and each call made twice: the two outputs bit-equal.
    Returns a summary; raises at the first case that fails."""
    import torch
    from legommenders_tpu_torch.ops.additive import (
        additive_pool, additive_pool_reference, pool_kernel,
    )

    t0 = time.perf_counter()
    worst = {"f32": 0.0, "bf16": 0.0}
    kernels = {}
    for N, L, d, h in pool_edge_cases():
        for dtype_name, dtype in (("f32", torch.float32),
                                  ("bf16", torch.bfloat16)):
            kernel = pool_kernel(dtype, L, d, h)[0]
            kernels[kernel] = kernels.get(kernel, 0) + 1
            args = pool_edge_inputs(N, L, dtype, device, N + L + d + h, h, d)
            with torch.inference_mode():
                a = additive_pool(*args)
                b = additive_pool(*args)
                want = additive_pool_reference(args[0].float(), *args[1:])
            torch.cuda.synchronize()
            err = float((a.float() - want).abs().max())
            top = float(want.abs().max())
            score = err if dtype_name == "f32" else err / max(top, 1e-30)
            worst[dtype_name] = max(worst[dtype_name], score)
            masked = args[1].sum(dim=1) == 0
            ok = (torch.equal(a, b) and bool((a[masked] == 0).all())
                  and score <= (F32_TOL if dtype_name == "f32"
                                else BF16_REL_TOL)
                  and kernel != MAIN_POOL_KERNEL)
            if not ok:
                raise RuntimeError(
                    f"additive_pool ({kernel}) at N {N} L {L} D {d} H {h} "
                    f"{dtype_name}: error {score} (largest {top}), "
                    f"bit-equal {torch.equal(a, b)}, all-masked rows 0 "
                    f"{bool((a[masked] == 0).all())}")
    return {"cases": len(pool_edge_cases()) * 2, "kernels": kernels,
            "f32_max_abs_err": worst["f32"],
            "bf16_max_rel_err": worst["bf16"], "bit_equal": True,
            "s": time.perf_counter() - t0}


def attention_inputs(dtype, device, seed, page=ATTN_PAGE):
    """q, k, v ~ N(0, 1) at one of bert-naml's attention pages; the bias is
    the one packed_mask_bias makes for 512 items whose valid lengths are
    those of the fixture's titles (15..30 tokens + [CLS], 2 [SEP],
    category: at most 34, the rest of a training item's 40 is padding)."""
    import torch
    from legommenders_tpu_torch.models.lm.layers import (
        pack_items, packed_mask_bias,
    )

    items, L, Dm = page["items"], page["L"], page["D"]
    g = torch.Generator(device=device).manual_seed(seed)
    lens = torch.randint(19, ATTN_PAGE["L"] + 1, (items,), generator=g,
                         device=device)
    mask = (torch.arange(L, device=device)[None] < lens[:, None]).int()
    _, mask_p, _ = pack_items(torch.zeros(items, L, 1, device=device), mask,
                              128 // L)
    B, T = mask_p.shape
    q, k, v = (torch.randn(B, T, Dm, generator=g, device=device).to(dtype)
               for _ in range(3))
    return q, k, v, packed_mask_bias(mask_p, L, dtype)[:, 0]


def check_attention(dtype_name: str, device) -> dict:
    import torch
    from torch.nn import functional as F
    from legommenders_tpu_torch.ops.attention import (
        packed_attention, reference_attention,
    )

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    heads = ATTN_PAGE["heads"]
    q, k, v, bias = attention_inputs(dtype, device, seed=7)
    B, T, Dm = q.shape
    # the head-split layout torch's own attention takes; timed only
    qh, kh, vh = (t.view(B, T, heads, Dm // heads).transpose(1, 2)
                  for t in (q, k, v))
    mask4 = bias[:, None]
    with torch.inference_mode():
        got = packed_attention(heads, 0.0, q, k, v, bias)
        want = reference_attention(heads, 0.0, q, k, v, bias)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        res = {"B": B, "T": T, "D": Dm, "heads": heads, "dtype": dtype_name,
               "max_abs_err": float(err.max()),
               "rel_err": float(err.max() / want.float().abs().max()),
               "finite": bool(torch.isfinite(got.float()).all()),
               "ms": time_ms(lambda: packed_attention(heads, 0.0, q, k, v,
                                                      bias), iters=50),
               "plain_ms": time_ms(lambda: reference_attention(
                   heads, 0.0, q, k, v, bias), iters=5),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=mask4), iters=50)}
    flops = 4.0 * B * T * T * Dm
    nbytes = 4 * B * T * Dm * q.element_size() + B * T * T * bias.element_size()
    peak = product_peak(dtype_name)
    res["bound_ms"], res["bound_by"] = roof(flops, nbytes, peak)
    res["bound_peak"] = f"{peak} {PEAK[peak] / 1e12:g} TFLOP/s"
    if dtype_name == "f32":
        # the bound on the CUDA cores, beside it
        res["cuda_core_bound_ms"] = roof(flops, nbytes, "f32")[0]
    ok = (res["max_abs_err"] <= F32_TOL if dtype_name == "f32"
          else res["rel_err"] <= BF16_REL_TOL)
    if not (ok and res["finite"]):
        raise RuntimeError(f"packed_attention disagrees with its plain "
                           f"version: {res}")
    return res


def check_attention_train(dtype_name: str, p: float, device) -> dict:
    """Forward, backward and keep mask at the training page, dropout p,
    against their plain versions given the mask kernel's mask; each
    kernel, its plain version and torch's SDPA (forward, and forward +
    backward) timed with CUDA events."""
    import torch
    from torch.nn import functional as F
    from legommenders_tpu_torch.ops.attention import (
        dropout_bits_reference, dropout_keep_mask, keep_threshold,
        packed_attention, packed_attention_backward, reference_attention,
        reference_attention_backward,
    )

    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    heads = TRAIN_PAGE["heads"]
    q, k, v, bias = attention_inputs(dtype, device, seed=11, page=TRAIN_PAGE)
    B, T, Dm = q.shape
    gen = torch.Generator(device=device).manual_seed(12)
    g = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    seed = torch.tensor([20231], dtype=torch.int32, device=device)
    res = {"B": B, "T": T, "D": Dm, "heads": heads, "dtype": dtype_name,
           "dropout": p}
    with torch.no_grad():
        keep = dropout_keep_mask(heads, p, B, T, seed) if p else None
        out = packed_attention(heads, p, q, k, v, bias, seed)
        want = reference_attention(heads, p, q, k, v, bias, keep)
        grads = packed_attention_backward(heads, p, q, k, v, bias, seed, g)
        wgrads = reference_attention_backward(heads, p, q, k, v, bias, g,
                                              keep)
        torch.cuda.synchronize()
    problems = []
    for name, a, b in (("out", out, want),) + tuple(
            zip(("dq", "dk", "dv"), grads, wgrads)):
        err = (a.float() - b.float()).abs().max().item()
        rel = err / b.float().abs().max().item()
        res[f"{name}_max_abs_err"], res[f"{name}_rel_err"] = err, rel
        finite = bool(torch.isfinite(a.float()).all())
        if not finite or (err > F32_TOL if dtype_name == "f32"
                          else rel > BF16_REL_TOL):
            problems.append(name)
    if p:
        plain = dropout_bits_reference(heads, B, T, int(seed.item()),
                                       device) >= keep_threshold(p)
        res["mask_equals_plain"] = bool(torch.equal(keep, plain))
        del plain
        res["mask_same_seed_equal"] = bool(torch.equal(
            keep, dropout_keep_mask(heads, p, B, T, seed)))
        res["mask_other_seed_differs"] = not torch.equal(
            keep, dropout_keep_mask(heads, p, B, T, seed + 1))
        n = keep.numel()
        res["keep_fraction"] = keep.float().mean().item()
        res["keep_fraction_sigma"] = ((res["keep_fraction"] - (1 - p))
                                      / (p * (1 - p) / n) ** 0.5)
        if not (res["mask_equals_plain"] and res["mask_same_seed_equal"]
                and res["mask_other_seed_differs"]
                and abs(res["keep_fraction_sigma"]) <= 4):
            problems.append("keep mask")
    if problems:
        raise RuntimeError(f"attention training kernels disagree with "
                           f"their plain versions ({problems}): {res}")
    xb, bb = q.element_size(), bias.element_size()
    peak = product_peak(dtype_name)
    res["bound_peak"] = f"{peak} {PEAK[peak] / 1e12:g} TFLOP/s"
    # recompute S, then dPd, dV, dQ, dK: five T x T x dh products per head
    bwd_work = (10.0 * B * T * T * Dm, 7 * B * T * Dm * xb + B * T * T * bb)
    res["bwd_bound_ms"], res["bwd_bound_by"] = roof(*bwd_work, peak)
    fwd_work = (4.0 * B * T * T * Dm, 4 * B * T * Dm * xb + B * T * T * bb)
    if dtype_name == "f32":
        # the bounds on the CUDA cores, beside them
        res["fwd_cuda_core_bound_ms"] = roof(*fwd_work, "f32")[0]
        res["bwd_cuda_core_bound_ms"] = roof(*bwd_work, "f32")[0]

    def fwd():
        packed_attention(heads, p, q, k, v, bias, seed)

    def bwd():
        packed_attention_backward(heads, p, q, k, v, bias, seed, g)

    # the head-split layout torch's own attention takes; timed only
    qh, kh, vh = (t.view(B, T, heads, Dm // heads).transpose(1, 2)
                  .detach().requires_grad_(True) for t in (q, k, v))
    gh = g.view(B, T, heads, Dm // heads).transpose(1, 2)
    mask4 = bias[:, None]

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4,
                                           dropout_p=p)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask4,
                                       dropout_p=p).backward(gh)

    with torch.no_grad():
        res["fwd_ms"] = time_ms(fwd, iters=50)
        res["bwd_ms"] = time_ms(bwd, iters=50)
        res["fwd_plain_ms"] = time_ms(lambda: reference_attention(
            heads, p, q, k, v, bias, keep), iters=3)
        res["bwd_plain_ms"] = time_ms(lambda: reference_attention_backward(
            heads, p, q, k, v, bias, g, keep), iters=3)
        if p:
            res["mask_ms"] = time_ms(lambda: dropout_keep_mask(
                heads, p, B, T, seed), iters=50)
            res["mask_plain_ms"] = time_ms(lambda: dropout_bits_reference(
                heads, B, T, 20231, device) >= keep_threshold(p), iters=2)
    res["sdpa_fwd_ms"] = time_ms(sdpa_fwd, iters=50)
    res["sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, iters=20)
    res["fwd_bound_ms"], res["fwd_bound_by"] = roof(*fwd_work, peak)
    res["mask_bound_ms"], res["mask_bound_by"] = mask_bound(B, heads, T)
    return res


# each kernel's device-side names, as the profiler lists them (no name is
# part of another)
KERNEL_NAMES = {"additive_pool": ("additive_pool_tc", "additive_pool_kernel",
                                  "additive_pool_long"),
                "packed_attention": ("attention_fwd_tc", "attention_fwd_tf32"),
                "packed_attention_backward": ("attention_bwd_tc",
                                              "attention_bwd_tf32"),
                "dropout_keep_mask": ("dropout_mask",)}

# the pool kernel of every main path (all run at the bf16 policy), and the
# one of the paths that pool over more than 128 positions (the flatten
# user operators)
MAIN_POOL_KERNEL = "additive_pool_tc"
LONG_POOL_KERNEL = "additive_pool_long"


def _is(name, key):
    """Whether the profiler's kernel `key` is the port's kernel `name`."""
    return any(k in key for k in KERNEL_NAMES[name])


# the runtime and driver calls that enqueue a kernel, as the tracer names
# them (cudaLaunchKernelExC and cuLaunchKernelEx start with these)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel")


def trace_records(events) -> dict:
    """One walk over a trace's raw events
    (`prof.profiler.kineto_results.events()`): the device time and count
    of each kernel (every device-side event but the port wrappers' own
    launch ranges, which show on the device side too, under the names of
    KERNEL_NAMES' keys), and what the trace says of its kernel launch
    calls: how many there are, how many device records, which calls have
    no device record under their correlation id (records the tracer
    lost), and of those how many lie inside each port wrapper's launch
    range (`ops.build.launch_range`), and how many launch calls each
    wrapper's ranges hold."""
    from torch.autograd import DeviceType

    calls, ran, ranges, by_name = {}, set(), [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in KERNEL_NAMES:  # a range's device side
                ran.add(e.correlation_id())
                tally = by_name.setdefault(e.name(), [0, 0])
                tally[0] += 1
                tally[1] += e.end_ns() - e.start_ns()
        elif e.name() in KERNEL_NAMES:
            ranges.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name().startswith(LAUNCH_CALLS) and e.correlation_id():
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns())

    # the ranges do not nest: the one a call lies in starts last before it
    ranges.sort(key=lambda r: r[1])
    starts = [lo for _, lo, _ in ranges]

    def wrapper(call):
        i = bisect.bisect_right(starts, call[0]) - 1
        if i >= 0 and call[1] <= ranges[i][2]:
            return ranges[i][0]
        return None

    in_range = {n: 0 for n in KERNEL_NAMES}
    lost = {n: 0 for n in KERNEL_NAMES}
    n_lost = 0
    for corr, call in calls.items():
        n = wrapper(call)
        if n:
            in_range[n] += 1
        if corr not in ran:
            n_lost += 1
            if n:
                lost[n] += 1
    return {"launch_calls": len(calls), "device_records": len(ran),
            "lost": n_lost, "calls_by_wrapper": in_range,
            "lost_by_wrapper": lost,
            "kernels": {k: {"count": c, "ms": ns / 1e6}
                        for k, (c, ns) in by_name.items()}}


# what cuBLAS names its matrix-product kernels on the H100 (cuBLASLt's
# nvjet, the xmma and CUTLASS kernels). A split-K product's partial-product
# kernel is one (`nvjet_..._splitK_NTT`, `xmma_..._split_k_kernel`); its
# reduction (`cublasLt::splitKreduce_kernel`) is not
GEMM_MARKERS = ("gemm", "nvjet", "xmma", "cutlass")


def _is_gemm(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in GEMM_MARKERS) and "reduce" not in low


def summarize_kernels(kernels: dict) -> dict:
    """From {kernel name: {"count", "ms"}} (`trace_records`): the device's
    busy ms, the launches, the ten longest kernels, the matrix products'
    launches and ms (`GEMM_MARKERS`), and each port kernel's ms, launches
    and launches by device-side name."""
    ours = {}
    for name in KERNEL_NAMES:
        evs = {k: r for k, r in kernels.items() if _is(name, k)}
        ours[name] = {"ms": sum(r["ms"] for r in evs.values()),
                      "launches": sum(r["count"] for r in evs.values()),
                      "by_kernel": {k: sum(r["count"] for key, r in
                                           evs.items() if k in key)
                                    for k in KERNEL_NAMES[name]}}
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:10]
    gemms = {k: r for k, r in kernels.items() if _is_gemm(k)}
    return {"busy_ms": sum(r["ms"] for r in kernels.values()),
            "kernel_launches": sum(r["count"] for r in kernels.values()),
            "gemm_launches": sum(r["count"] for r in gemms.values()),
            "gemm_ms": sum(r["ms"] for r in gemms.values()),
            "kernels": ours,
            "top_kernels": [{"name": k[:60], "count": r["count"],
                             "ms": r["ms"]} for k, r in top]}


def check_profiled_launches(listed: dict, counted: dict,
                            trace: dict) -> int:
    """Hold each port kernel's profiled launches (`listed`) against its
    wrapper's count over the same window: raises where the profiler lists
    more, and where it lists fewer unless the trace holds, inside that
    wrapper's launch ranges, as many launch calls whose device record the
    tracer lost (`trace_records`). Returns the port's launches missing
    from the trace."""
    short = {n: counted[n] - listed[n] for n in listed}
    if any(d < 0 or d > trace["lost_by_wrapper"][n]
           for n, d in short.items()):
        raise RuntimeError(
            f"the profiler lists {listed} launches of the port's kernels, "
            f"their wrappers counted {counted} in the same window; the "
            f"trace has {trace['launch_calls']} launch calls "
            f"({trace['calls_by_wrapper']} in the wrappers' ranges), "
            f"{trace['device_records']} device records, and "
            f"{trace['lost']} launch calls without their device record "
            f"({trace['lost_by_wrapper']} in the wrappers' ranges)")
    return sum(short.values())


# the host's seconds in profile_window's summaries since the run began
PROFILE_SUMMARY_S = [0.0]


def profile_window(fn) -> dict:
    """torch.profiler over one call of fn: device time by kernel and the
    device's idle share of the window's wall time (the profiler's own host
    cost included), and each port kernel's device time and launches.
    Raises when a port kernel's profiled launches differ from its wrapper's
    count over the same window (a kernel whose name the profiler lists
    otherwise would read 0 ms), unless the trace itself shows the tracer
    lost the device records of that many of the wrapper's launch calls
    (`check_profiled_launches`; the record keeps the count of lost
    records, `lost_records`), and when a pool launch is not the
    tensor-core kernel's (every window is a main path at bf16) or, over a
    flattened history (L > 128), the long-sequence kernel's. The summary
    is one walk over the trace's events (`trace_records`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = _counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_summary = time.perf_counter()
    counted = {k: v - before[k] for k, v in _counts().items()}
    trace = trace_records(prof.profiler.kineto_results.events())
    summary = summarize_kernels(trace["kernels"])
    ours, busy_ms = summary["kernels"], summary["busy_ms"]
    lost = check_profiled_launches(
        {n: r["launches"] for n, r in ours.items()}, counted, trace)
    summary_s = time.perf_counter() - t_summary
    PROFILE_SUMMARY_S[0] += summary_s
    if lost:
        log(f"[profile] the tracer lost {trace['lost']} of "
            f"{trace['launch_calls']} kernel records, of them the port's "
            f"{trace['lost_by_wrapper']}: {counted} counted")
    pool = ours["additive_pool"]
    main = (pool["by_kernel"][MAIN_POOL_KERNEL]
            + pool["by_kernel"][LONG_POOL_KERNEL])
    if main != pool["launches"]:
        raise RuntimeError(f"additive_pool: of {pool['launches']} profiled "
                           f"launches on a main path, only {main} are "
                           f"{MAIN_POOL_KERNEL}'s or {LONG_POOL_KERNEL}'s: "
                           f"{pool['by_kernel']}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernels": ours,
            # no device time in the trace means the share was not measured
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "kernel_launches": summary["kernel_launches"],
            "gemm_launches": summary["gemm_launches"],
            "gemm_ms": summary["gemm_ms"],
            "launch_calls": trace["launch_calls"],
            "lost_records": trace["lost"],
            "port_calls": trace["calls_by_wrapper"],
            # the host's seconds summarising the trace, after the window
            "summary_s": summary_s,
            "top_kernels": summary["top_kernels"]}


def _plain_attention():
    """packed_attention with its kernels patched out: an autograd Function
    whose forward is the plain forward and whose backward is the plain
    backward (the kernels' rounding points), at dropout 0 (the
    comparisons run without dropout)."""
    import torch
    from legommenders_tpu_torch.ops.attention import (
        reference_attention, reference_attention_backward,
    )

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, num_heads, q, k, v, bias):
            ctx.num_heads = num_heads
            ctx.save_for_backward(q, k, v, bias)
            return reference_attention(num_heads, 0.0, q, k, v, bias)

        @staticmethod
        def backward(ctx, g):
            q, k, v, bias = ctx.saved_tensors
            dq, dk, dv = reference_attention_backward(ctx.num_heads, 0.0, q,
                                                      k, v, bias, g)
            return None, dq, dk, dv, None

    def stand_in(num_heads, dropout_p, q, k, v, bias, seed=None,
                 head_offset=0):
        if dropout_p:
            raise ValueError("the plain stand-in runs at dropout 0")
        return Plain.apply(num_heads, q, k, v, bias)

    return stand_in


def run_path(name: str, model_cfg: dict, data, device,
             attention_per_item_page: int) -> dict:
    """One serving path through Manager + Tester.test(); returns its record.
    Every kernel's launch count is set to 0 just before Tester.test() and
    read just after: the pool must launch once per item and user page, the
    attention `attention_per_item_page` times per item page."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.ops.additive import additive_pool
    from legommenders_tpu_torch.ops.attention import packed_attention
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    counters = {"additive_pool": additive_pool,
                "packed_attention": packed_attention}
    rec = {"path": name}
    t0 = time.perf_counter()
    m = Manager(model_cfg=model_cfg, exp_cfg=EXP_CFG, data=data,
                device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    cache = m.cache
    rec["item_pages"] = len(cache.pages(cache.num_items))
    rec["user_pages"] = len(cache.pages(cache.num_users))
    rec["expected_launches"] = {
        "additive_pool": rec["item_pages"] + rec["user_pages"],
        "packed_attention": attention_per_item_page * rec["item_pages"]}
    rec["metrics"] = res

    # the same phases again, warm, one at a time
    ev = tester.evaluator

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    _, rec["cache_s"] = timed(cache.cache)
    scores, rec["score_s"] = timed(lambda: ev.score_phase_device("test"))
    dev_metrics, rec["metric_s"] = timed(lambda: ev.metrics("test", scores))
    ph = ev.phase("test")
    rec["rows"] = ph.n
    host_metrics = ev.pool(scores.float().cpu().numpy(), ph.labels, ph.groups)
    rec["metric_vs_numpy_err"] = max(abs(dev_metrics[k] - host_metrics[k])
                                     for k in host_metrics)
    rec["profile"] = profile_window(lambda: (
        cache.cache(), ev.metrics("test", ev.score_phase_device("test"))))

    _repr_check(m, cache, rec)

    problems = []
    if rec["item_repr_shape"] != [data.num_items, 64] or \
            rec["user_repr_shape"] != [data.num_users, 64]:
        problems.append("repr shapes")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values()):
        problems.append("metrics not finite in [0, 1]")
    if rec["metric_vs_numpy_err"] > 1e-5:
        problems.append("device metrics disagree with the numpy pool")
    for part in ("item", "user"):
        if not rec[f"{part}_repr_finite"]:
            problems.append(f"{part} reprs not finite")
        if rec[f"{part}_repr_rel_err"] > BF16_REL_TOL:
            problems.append(f"{part} reprs disagree with the plain path")
    if rec["launches"] != rec["expected_launches"]:
        problems.append("kernel launches on the path")
    if problems:
        raise RuntimeError(f"{name} path failed ({', '.join(problems)}): "
                           f"{rec}")
    del m, tester, cache, ev
    torch.cuda.empty_cache()
    return rec


def _repr_check(m, cache, rec):
    """The served reprs of the first REPR_ROWS items and users against the
    same model with every kernel patched out for its plain version, on the
    card, page by page: each part's largest error over its largest value
    and whether it is finite, into `rec`."""
    from unittest import mock

    import torch
    import legommenders_tpu_torch.models.common as common
    import legommenders_tpu_torch.models.lm.layers as lm_layers
    from legommenders_tpu_torch.ops.additive import additive_pool_reference

    item_repr, user_repr = cache.item_repr, cache.user_repr
    rec["item_repr_shape"] = list(item_repr.shape)
    rec["user_repr_shape"] = list(user_repr.shape)
    with mock.patch.object(common, "additive_pool", additive_pool_reference), \
            mock.patch.object(lm_layers, "packed_attention",
                              _plain_attention()), \
            torch.inference_mode():
        item_ref = torch.cat([
            m.model.encode_item_page(
                {c: a[s:e] for c, a in cache.item_contents.items()})
            for s, e in cache.pages(min(REPR_ROWS, cache.num_items))])
        user_ref = torch.cat([
            m.model.encode_user(item_repr[cache.hist_safe[s:e]],
                                cache.hist_mask[s:e])
            for s, e in cache.pages(min(REPR_ROWS, cache.num_users))])
    for part, got, want in (("item", item_repr, item_ref),
                            ("user", user_repr, user_ref)):
        err = (got[:len(want)].float() - want.float()).abs().max()
        rec[f"{part}_repr_rel_err"] = float(err / want.float().abs().max())
        rec[f"{part}_repr_finite"] = bool(torch.isfinite(got).all())


class deterministic:
    """torch.use_deterministic_algorithms for a block (warn_only: the
    port's own kernels launch outside the dispatcher), the setting before
    it restored after. Two backward passes on the card otherwise differ in
    their last bits: index_add_ (HistoryGradPlan's backward) adds by
    atomics, in no fixed order (NAML's plans against themselves:
    legommenders_tpu_torch/tools/plan_grad_noise.py)."""

    def __enter__(self):
        import torch

        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        import torch

        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])
        return False


def _counters():
    from legommenders_tpu_torch.ops.additive import additive_pool
    from legommenders_tpu_torch.ops.attention import (
        dropout_keep_mask, packed_attention, packed_attention_backward,
    )

    return {"additive_pool": additive_pool,
            "packed_attention": packed_attention,
            "packed_attention_backward": packed_attention_backward,
            "dropout_keep_mask": dropout_keep_mask}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0
        if hasattr(fn, "offsets"):
            fn.offsets.clear()


def _counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


def _offsets() -> dict:
    """The attention kernels' launches by head offset since the counts
    were set to 0."""
    return {k: dict(fn.offsets) for k, fn in _counters().items()
            if hasattr(fn, "offsets")}


def _train_steps(m, data, device, n_steps: int, profile: bool = True,
                 batch: int = TRAIN_BATCH) -> dict:
    """1 warm step, then n_steps each timed to the device's end of it, with
    every launch count set to 0 before them; the record of the timed steps
    (losses, step ms at the median, impressions/s at that median, launches
    per step, peak memory, the catalog-grad plans of the last step) after
    one more under torch.profiler (with `profile`: the profiler's own
    summary of a step of ~80,000 launches takes the host tens of
    seconds), and the pipeline; `batch` impressions a step."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline,
    )
    from legommenders_tpu_torch.ops import catalog_grad
    from legommenders_tpu_torch.runtime import steps

    cfg = m.lego_cfg
    dp = DeviceTrainPipeline(data, batch_size=batch,
                             neg_count=cfg.neg_count,
                             use_neg_sampling=cfg.use_neg_sampling, seed=0,
                             device=device)
    opt = steps.adam(m.model, TRAIN_LR)
    step = dp.make_fused_train_step(m.model, m.contents.columns, opt, seed=0)
    # row-index slices, epoch after epoch
    stream = itertools.chain.from_iterable(iter(dp.epoch_indices, None))
    rec = {"batch": batch, "rows": dp.n, "trainable_tensors": len(
        steps.trainable_parameters(m.model)), "trainable_values": sum(
        p.numel() for p in steps.trainable_parameters(m.model))}
    t0 = time.perf_counter()
    rec["warm_loss"] = step(next(stream), 0).item()
    rec["warm_step_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    catalog_grad.record_trace((), ())
    catalog_grad.record_history(False)
    _zero_counts()
    losses, times = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        losses.append(step(next(stream), i + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec["launches"] = _counts()
    rec["launches_per_step"] = {k: v / n_steps
                                for k, v in rec["launches"].items()}
    rec["plans"] = _plans_live(m.model)
    rec["losses"] = [x.item() for x in losses]
    rec["step_ms_each"] = [t * 1e3 for t in times]
    rec["step_ms"] = statistics.median(times) * 1e3
    rec["impressions_per_s"] = batch / statistics.median(times)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(rec["losses"] + [rec["warm_loss"]])):
        raise RuntimeError(f"training losses not finite: {rec}")
    if profile:
        rec["profile"] = profile_window(
            lambda: step(next(stream), n_steps + 1))
    return rec, dp


def _grads(m, batch, plain: bool):
    """(loss, {name: f32 gradient}) of every trainable tensor of m's model
    on `batch` at dropout 0 (no generator); with `plain`, every kernel is
    patched out for its plain version (plain forwards and backwards)."""
    import contextlib
    from unittest import mock

    import legommenders_tpu_torch.models.common as common
    import legommenders_tpu_torch.models.lm.layers as lm_layers
    from legommenders_tpu_torch.ops.additive import additive_pool_reference
    from legommenders_tpu_torch.runtime import steps

    model = m.model
    loss_fn = steps.make_loss_fn(model, m.contents.columns, True)
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(mock.patch.object(
                common, "additive_pool", additive_pool_reference))
            stack.enter_context(mock.patch.object(
                lm_layers, "packed_attention", _plain_attention()))
        model.zero_grad(set_to_none=True)
        loss = loss_fn(batch, None)
        loss.backward()
    out = {n: p.grad.float().clone() for n, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), out


def _rel_errs(got: dict, want: dict) -> dict:
    """Per tensor: the largest |got - want| over the largest |want|."""
    if got.keys() != want.keys():
        raise RuntimeError(f"gradients of different tensors: {sorted(got)} "
                           f"vs {sorted(want)}")
    return {n: (got[n] - want[n]).abs().max().item()
            / max(want[n].abs().max().item(), 1e-30) for n in want}


def _cache_err(got, want, mask, rows: int = 4096) -> float:
    """The largest |got - want| at the cache's valid positions over the
    largest |want| there, a block of rows at a time."""
    err = scale = 0.0
    for s in range(0, want.shape[0], rows):
        keep = mask[s:s + rows, :, None] > 0
        w = want[s:s + rows].float()
        err = max(err, ((got[s:s + rows].float() - w).abs() * keep)
                  .max().item())
        scale = max(scale, (w.abs() * keep).max().item())
    return err / scale


def _lower_cache(m):
    """m's lower slice over the catalog again, padded as the cache is:
    (hidden, mask) on the device."""
    from legommenders_tpu_torch.models.operators.lm_ops import (
        LM_HIDDEN_KEY, LM_MASK_KEY,
    )
    from legommenders_tpu_torch.runtime.lm_cache import (
        build_lm_hidden, device_entries,
    )

    cols = {c: a for c, a in m.contents.columns.items()
            if c not in (LM_HIDDEN_KEY, LM_MASK_KEY)}
    out = device_entries(
        *build_lm_hidden(m.model, cols, m.lego_cfg.cache_page_size),
        m.model.item_op.lm_dtype, m.device)
    return out[LM_HIDDEN_KEY], out[LM_MASK_KEY]


def precision_check(m16, dp, data, device) -> dict:
    """The training gradients and the layer-split cache of the bf16 model
    (as trained by the timed steps, lora_B drawn non-zero) against the same
    weights at f32, on the card, on one batch at dropout 0. Gradients of
    every trainable tensor from four runs: the kernels (K) and their plain
    versions (P), each at bf16 and f32. Gates, per tensor, each error the
    largest difference over the largest value of the second operand:
      - f32: K32 within 2e-2 of P32;
      - bf16: K16 within 2e-2 of P16, or, where bf16 itself moves the
        gradient further, within half the plain path's own bf16 error
        (P16 against P32).
    At bf16 the plain path's gradients lie 3e-2 to 3e-1 of their largest
    value from its f32 ones (H100, seed 0): the query LoRA and the item
    pool's parameters get their gradients through softmax backwards whose
    terms cancel (they sum to 0 over each row or item), so rounding flips
    upstream move them by a large share of their size. The kernels round
    where the plain versions round; what they change is the order of f32
    sums, a fraction of that spread (at most 0.29 of it, H100). Also
    gated by the bf16 rule: K16 against K16 under `full` remat (the
    model's policy, `ffn` in phase 5, keeps some of a page's outputs and
    recomputes the rest; it changes no value). Recorded besides: K16
    against P32, K16 run twice, and the bf16 cache built through the
    kernel (as the port builds it) and through the plain unfused attention
    (as the JAX package builds it), each against the f32 cache."""
    import copy

    import torch
    from legommenders_tpu_torch.data.device_pipeline import step_generator
    from legommenders_tpu_torch.models.lm.layers import BertSelfAttention
    from legommenders_tpu_torch.models.operators.lm_ops import (
        LM_HIDDEN_KEY, LM_MASK_KEY,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(5)
    with torch.no_grad():
        for mod in m16.model.modules():
            if getattr(mod, "lora_r", 0) > 0:
                mod.lora_B.normal_(0.0, 0.05, generator=g)
    idx = next(dp.epoch_indices(shuffle=False))
    batch = dp.assemble(idx, step_generator(0, 10 ** 6, device))
    rec = {"loss": {}, "remat": m16.model.item_page_remat}
    grads = {}
    for name, m, plain in (("K16", m16, False), ("K16_again", m16, False),
                           ("P16", m16, True)):
        rec["loss"][name], grads[name] = _grads(m, batch, plain)
    # the same gradients with every page recomputed whole
    m16.model.item_page_remat = "full"
    rec["loss"]["K16_full"], grads["K16_full"] = _grads(m16, batch, False)
    m16.model.item_page_remat = rec["remat"]

    # the lower slice at bf16 through the plain unfused attention
    attn = [mod for mod in m16.model.item_op.lm_lower.modules()
            if isinstance(mod, BertSelfAttention)]
    for mod in attn:
        mod.fused = False
    unfused16, _ = _lower_cache(m16)
    for mod in attn:
        mod.fused = True

    cfg = copy.deepcopy(BERT_TRAIN_CFG)
    cfg["config"]["item_config"]["lm_dtype"] = "f32"
    m32 = Manager(model_cfg=cfg, exp_cfg={"policy": {"dtype": "f32"}},
                  data=data, device=device, seed=0)
    m32.model.load_state_dict(m16.model.state_dict())
    assert m32.prepare_lm_cache(root=None)
    cols16, cols32 = m16.contents.columns, m32.contents.columns
    if not torch.equal(cols16[LM_MASK_KEY], cols32[LM_MASK_KEY]):
        raise RuntimeError("the bf16 and f32 caches have different masks")
    mask = cols32[LM_MASK_KEY]
    rec["cache_rel_err"] = {
        "kernel_bf16_vs_unfused_bf16": _cache_err(
            cols16[LM_HIDDEN_KEY], unfused16, mask),
        "kernel_bf16_vs_f32": _cache_err(cols16[LM_HIDDEN_KEY],
                                         cols32[LM_HIDDEN_KEY], mask),
        "unfused_bf16_vs_f32": _cache_err(unfused16, cols32[LM_HIDDEN_KEY],
                                          mask)}
    del unfused16
    for name, plain in (("K32", False), ("P32", True)):
        rec["loss"][name], grads[name] = _grads(m32, batch, plain)
    del m32, cols32
    torch.cuda.empty_cache()

    pairs = {"K32_vs_P32": ("K32", "P32"), "K16_vs_P16": ("K16", "P16"),
             "P16_vs_P32": ("P16", "P32"), "K16_vs_P32": ("K16", "P32"),
             "K16_vs_K16_again": ("K16_again", "K16"),
             "K16_vs_K16_full": ("K16", "K16_full")}
    rec["rel_err"] = {k: _rel_errs(grads[a], grads[b])
                      for k, (a, b) in pairs.items()}
    rec["max_rel_err"] = {k: max(v.values())
                          for k, v in rec["rel_err"].items()}
    rec["bf16_limit"] = {n: max(BF16_REL_TOL, 0.5 * e) for n, e in
                         rec["rel_err"]["P16_vs_P32"].items()}
    rec["tensors"] = len(grads["P32"])
    rec["s"] = time.perf_counter() - t0
    problems = [f"f32 {n}" for n, e in rec["rel_err"]["K32_vs_P32"].items()
                if e > BF16_REL_TOL]
    problems += [f"bf16 {n}" for n, e in rec["rel_err"]["K16_vs_P16"].items()
                 if e > rec["bf16_limit"][n]]
    problems += [f"{rec['remat']} remat {n}" for n, e in
                 rec["rel_err"]["K16_vs_K16_full"].items()
                 if e > rec["bf16_limit"][n]]
    if problems:
        raise RuntimeError(f"training gradients disagree with the plain "
                           f"path or with full remat ({problems}): {rec}")
    return rec


def run_lm_training(data, device) -> dict:
    """bert-naml layer-split training at full width (see the header)."""
    import torch
    from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY
    from legommenders_tpu_torch.runtime.manager import Manager

    rec = {"path": "bert-naml layer-split training"}
    t0 = time.perf_counter()
    m = Manager(model_cfg=BERT_TRAIN_CFG, exp_cfg=EXP_CFG, data=data,
                device=device, seed=0)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    op = m.model.item_op
    _zero_counts()
    t0 = time.perf_counter()
    assert m.prepare_lm_cache(root=None)
    torch.cuda.synchronize()
    rec["cache_s"] = time.perf_counter() - t0
    rec["cache_launches"] = _counts()
    hid = m.contents.columns[LM_HIDDEN_KEY]
    rec["cache_shape"], rec["cache_dtype"] = list(hid.shape), str(hid.dtype)
    rec["cache_gb"] = hid.numel() * hid.element_size() / 2 ** 30
    pages = -(-data.num_items // m.lego_cfg.cache_page_size)
    rec["expected_cache_launches"] = op.resolved_tune_from * pages
    start = _snapshot(m.model)
    train, dp = _train_steps(m, data, device, LM_STEPS)
    rec.update(train)
    # the same model and batches under `full` remat: the A/B of the policy
    trained = _snapshot(m.model)
    m.model.load_state_dict(start)
    m.model.item_page_remat = "full"
    rec["full_remat"], _ = _train_steps(m, data, device, AB_STEPS)
    m.model.item_page_remat = "ffn"
    m.model.load_state_dict(trained)
    del start, trained
    rec["remat_loss_rel_err"] = shared_loss_err(rec, rec["full_remat"])
    n_pages = -(-data.num_items // m.model.item_page_size)
    upper = op.num_hidden_layers - op.resolved_tune_from
    rec["expected_launches_per_step"] = {
        "packed_attention": 2 * upper * n_pages,
        "packed_attention_backward": upper * n_pages,
        "additive_pool": 2 * n_pages + 1, "dropout_keep_mask": 0}
    log(f"[main] {json.dumps(rec)}")
    del hid
    rec["grad_check"] = precision_check(m, dp, data, device)
    del m, dp, op
    torch.cuda.empty_cache()
    problems = []
    if rec["cache_launches"]["packed_attention"] != \
            rec["expected_cache_launches"]:
        problems.append("cache-build launches")
    if rec["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("launches per step")
    if rec["full_remat"]["launches_per_step"] != \
            rec["expected_launches_per_step"]:
        problems.append("launches per step under full remat")
    if rec["remat_loss_rel_err"] > BF16_REL_TOL:
        problems.append("losses under ffn against full remat")
    if problems:
        raise RuntimeError(f"bert-naml training failed ({problems}): {rec}")
    return rec


def _snapshot(model) -> dict:
    """A copy of the model's state on its device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def shared_loss_err(a: dict, b: dict) -> float:
    """The largest relative difference between the losses two `_train_steps`
    runs share (the warm step's and the timed steps' of the shorter), run
    from one state with one pipeline and step seeds: a remat policy or a
    knob that computes the same function gives the same losses, up to
    rounding."""
    n = min(len(a["losses"]), len(b["losses"]))
    pairs = zip([a["warm_loss"]] + a["losses"][:n],
                [b["warm_loss"]] + b["losses"][:n])
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in pairs)


def remat_ab_line(rec: dict, other: dict, names=("ffn", "full")) -> str:
    """One line of a remat A/B: step ms, peak GB, idle share and the
    profiled matrix-product launches a step of each side."""
    def side(r):
        pr = r.get("profile", {})
        return (f"step {r['step_ms']:.1f} ms, peak "
                f"{r['peak_memory_gb']:.2f} GB, idle share "
                f"{pr.get('device_idle_share')}, GEMM launches "
                f"{pr.get('gemm_launches')} ({pr.get('gemm_ms', 0):.1f} ms)")
    return (f"{names[0]}: {side(rec)}; {names[1]}: {side(other)}; shared "
            f"losses within {shared_loss_err(rec, other):.3g} (gate "
            f"{BF16_REL_TOL:g})")


def run_naml_training(data, device) -> dict:
    """NAML training at full width: the pool launches once for the
    catalog and once for the users per step."""
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager

    m = Manager(model_cfg=MODEL_CFG, exp_cfg=EXP_CFG, data=data,
                device=device, seed=0)
    rec = {"path": "naml training"}
    train, dp = _train_steps(m, data, device, NAML_STEPS)
    rec.update(train)
    rec["expected_launches_per_step"] = {
        "additive_pool": 2, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    if rec["launches_per_step"] != rec["expected_launches_per_step"]:
        raise RuntimeError(f"naml training launches: {rec}")
    if not rec["plans"]["all_live"]:
        raise RuntimeError(f"naml training: catalog-grad plans not live: "
                           f"{rec['plans']}")
    del m, dp
    torch.cuda.empty_cache()
    return rec


# the run loop (phase 6): Trainer at batch 2,048, 4 negatives, 2 epochs of
# 8 steps, 4 warmup updates, loss read twice an epoch
RUN_POLICY = {"batch_size": TRAIN_BATCH, "lr": TRAIN_LR, "epoch": 2,
              "epoch_batch": 8, "n_warmup": 4, "check_interval": -2,
              "dtype": "bf16"}
DEVICE_BATCH_STEPS, LATENCY_BATCHES, LM_TRAINER_STEPS = 8, 20, 2
FULL_SCORE_ROWS = 2048
# full forward against the cached path: the first scores within 1e-2 of
# the cached path's largest score (2.5 bf16 steps of it), the metrics
# within 1e-3 (both paths run the same kernels on the same items; they
# agreed exactly on an NVIDIA H100 80GB HBM3 at 700 W)
FULL_SCORE_REL_TOL, FULL_METRIC_TOL = 1e-2, 1e-3
# the metric engine sums groups with atomics: equal scores give metrics
# that may differ in their last bits
METRIC_REPEAT_TOL = 1e-6


def _eval_pages(m) -> int:
    """Pool launches of one pass through the repr caches: one per item page
    and one per user page."""
    cache = m.cache
    return (len(cache.pages(cache.num_items))
            + len(cache.pages(cache.num_users)))


def _timed_trainer(m, seed=0, **kw):
    """A Trainer whose steps are each timed to the device's end."""
    from legommenders_tpu_torch.runtime.trainer import Trainer
    from legommenders_tpu_torch.utils.timer import Timer

    timer = Timer(activate=True)
    return Trainer(m, seed=seed, timer=timer, **kw), timer


def _step_record(tr, timer) -> dict:
    """Step ms (median of the steps after the first), impressions/s at
    that median, and the share of the step loop spent waiting for host
    batches."""
    step_s = timer.samples["step"]
    med = statistics.median(step_s[1:])
    return {"steps": tr.global_step, "step_ms": med * 1e3,
            "step_ms_first": step_s[0] * 1e3,
            "impressions_per_s": TRAIN_BATCH / med,
            "prefetch_wait_s": tr.prefetch_wait_s,
            "prefetch_wait_share": tr.prefetch_wait_s / (
                tr.prefetch_wait_s + sum(step_s)),
            "epochs": tr.epochs}


def run_loop_naml(data, device, tmp) -> dict:
    """6.1: NAML through Trainer.train() + test() on host batches (the
    default path): dev through the caches each epoch, the best checkpoint
    saved to `tmp` and reloaded before the test. The checkpoint functions
    the Trainer calls are wrapped to time them and to keep a copy of what
    was saved: the reloaded weights must equal it bit for bit and score as
    it does."""
    import numpy as np
    import torch
    from legommenders_tpu_torch import native
    from legommenders_tpu_torch.runtime import trainer as trainer_mod
    from legommenders_tpu_torch.runtime.manager import Manager

    exp = {"policy": dict(RUN_POLICY)}
    m = Manager(model_cfg=MODEL_CFG, exp_cfg=exp, data=data, device=device,
                seed=0)
    ckpt = os.path.join(tmp, "naml.ckpt")
    tr, timer = _timed_trainer(m, ckpt_path=ckpt)
    saved, io_s = {}, {"save": [], "load": []}
    save, load = trainer_mod.save_auto, trainer_mod.load_auto

    def timed_save(path, model, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, model, *a, **k)
        io_s["save"].append(time.perf_counter() - t0)
        saved.update({n: v.detach().clone()
                      for n, v in model.state_dict().items()})

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        out = load(*a, **k)
        torch.cuda.synchronize()
        io_s["load"].append(time.perf_counter() - t0)
        return out

    rec = {"path": "naml Trainer, host batches", "policy": RUN_POLICY}
    trainer_mod.save_auto = timed_save
    trainer_mod.load_auto = timed_load
    try:
        _zero_counts()
        t0 = time.perf_counter()
        out = tr.train()
        rec["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["test"] = tr.test()
        torch.cuda.synchronize()
        rec["test_s"] = time.perf_counter() - t0
        rec["launches"] = _counts()
    finally:
        trainer_mod.save_auto, trainer_mod.load_auto = save, load
    rec.update(_step_record(tr, timer))
    rec["best_dev"] = out["best_dev"]
    rec["sampler"] = native.backend()
    pages = _eval_pages(m)
    evals = len(tr.epochs) + 1
    rec["expected_launches"] = {
        "additive_pool": 2 * tr.global_step + evals * pages,
        "packed_attention": 0, "packed_attention_backward": 0,
        "dropout_keep_mask": 0}
    rec["pool_launches_per_step"] = (
        rec["launches"]["additive_pool"] - evals * pages) / tr.global_step
    rec["checkpoint_bytes"] = os.path.getsize(ckpt)
    rec["checkpoint_save_s"] = io_s["save"]
    rec["checkpoint_load_s"] = io_s["load"]
    rec["reload_bit_exact"] = all(torch.equal(v, saved[n]) for n, v in
                                  m.model.state_dict().items())
    m.model.load_state_dict(saved)
    rec["in_memory_test"] = tr.test()
    rec["reload_vs_in_memory"] = max(
        abs(rec["test"][k] - rec["in_memory_test"][k]) for k in rec["test"])
    problems = []
    if rec["sampler"] != "c":
        problems.append("the C negative sampler did not run")
    if rec["launches"] != rec["expected_launches"]:
        problems.append("kernel launches")
    if not (np.isfinite(rec["best_dev"]) and all(
            np.isfinite(e["loss"]) for e in tr.epochs) and all(
            np.isfinite(v) and 0 <= v <= 1 for v in rec["test"].values())):
        problems.append("losses or metrics not finite")
    if not rec["reload_bit_exact"] or not io_s["load"]:
        problems.append("the reloaded best differs from what was saved")
    if rec["reload_vs_in_memory"] > METRIC_REPEAT_TOL:
        problems.append("the reloaded best scores otherwise")
    if problems:
        raise RuntimeError(f"naml Trainer failed ({problems}): {rec}")
    return rec, m, tr


def run_loop_device_batches(data, device) -> dict:
    """6.2: the same Trainer with `device_batching`, for 8 steps."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager

    policy = {**RUN_POLICY, "epoch": 1, "epoch_batch": DEVICE_BATCH_STEPS,
              "device_batching": True}
    m = Manager(model_cfg=MODEL_CFG, exp_cfg={"policy": policy}, data=data,
                device=device, seed=0)
    tr, timer = _timed_trainer(m)
    rec = {"path": "naml Trainer, device batches", "policy": policy}
    _zero_counts()
    out = tr.train()
    torch.cuda.synchronize()
    rec["launches"] = _counts()
    rec.update(_step_record(tr, timer))
    rec["best_dev"] = out["best_dev"]
    rec["expected_launches"] = {
        "additive_pool": 2 * tr.global_step + _eval_pages(m),
        "packed_attention": 0, "packed_attention_backward": 0,
        "dropout_keep_mask": 0}
    if rec["launches"] != rec["expected_launches"] or not np.isfinite(
            rec["best_dev"]) or tr.global_step != DEVICE_BATCH_STEPS:
        raise RuntimeError(f"naml Trainer on device batches failed: {rec}")
    del m, tr
    torch.cuda.empty_cache()
    return rec


def run_full_forward(m, tr) -> dict:
    """6.3: the trained model's test phase through full forwards (the path
    of use_fast_eval off), beside the cached Tester.test(). Each page of
    the eval batch size encodes the whole catalog (full_catalog_encode
    "auto": the catalog is no larger than 2 B (K + S) occurrences) and
    pools its users: two pool launches a page."""
    import torch
    from legommenders_tpu_torch.runtime.tester import Tester

    ev = tr.evaluator
    ph = ev.phase("test")
    P, S = ev.batch_size, m.data.history_matrix().shape[1]
    n_items = m.data.num_items
    model = m.model
    use_catalog = model.full_catalog_encode == "on" or (
        model.full_catalog_encode == "auto" and n_items <= 2 * P * (1 + S))
    if not (use_catalog and model.item_page_size == 0):
        raise RuntimeError("the full-forward pages were expected to encode "
                           "the catalog in one pass")
    pages = -(-ph.n // P)
    rec = {"path": "naml full-forward test", "rows": ph.n,
           "eval_batch": P, "pages": pages,
           "expected_launches": {"additive_pool": 2 * pages,
                                 "packed_attention": 0,
                                 "packed_attention_backward": 0,
                                 "dropout_keep_mask": 0}}
    tester = Tester(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec["cached_test"] = tester.test()
    torch.cuda.synchronize()
    rec["cached_test_s"] = time.perf_counter() - t0
    cached_scores = ev.score_phase_device("test")
    _zero_counts()
    t0 = time.perf_counter()
    rec["full_test"] = ev.evaluate("test", use_cache=False)
    torch.cuda.synchronize()
    rec["full_test_s"] = time.perf_counter() - t0
    rec["launches"] = _counts()
    full = ev.score_phase_device_full("test")[:FULL_SCORE_ROWS].float()
    want = cached_scores[:FULL_SCORE_ROWS].float()
    rec["score_rel_err"] = float((full - want).abs().max()
                                 / want.abs().max())
    rec["metric_max_abs_diff"] = max(
        abs(rec["full_test"][k] - rec["cached_test"][k])
        for k in rec["cached_test"])
    if (rec["launches"] != rec["expected_launches"]
            or rec["score_rel_err"] > FULL_SCORE_REL_TOL
            or rec["metric_max_abs_diff"] > FULL_METRIC_TOL):
        raise RuntimeError(f"full-forward test failed: {rec}")
    return rec


def run_latency(m) -> dict:
    """6.4: Tester.latency over 20 eval batches, through the caches (their
    build is one pass of pages) and by full forwards (two pool launches a
    batch)."""
    from legommenders_tpu_torch.runtime.tester import Tester

    tester = Tester(m)
    rec = {"path": "naml Tester.latency", "batches": LATENCY_BATCHES,
           "eval_batch": tester.evaluator.batch_size}
    for use_cache, want in ((True, _eval_pages(m)),
                            (False, 2 * LATENCY_BATCHES)):
        key = "cached" if use_cache else "full"
        _zero_counts()
        rec[f"{key}_ms_per_batch"] = tester.latency(LATENCY_BATCHES,
                                                    use_cache=use_cache)
        rec[f"{key}_launches"] = _counts()
        if rec[f"{key}_launches"]["additive_pool"] != want:
            raise RuntimeError(f"latency ({key}) launches: {rec}")
    return rec


def run_loop_lm(data, device) -> dict:
    """6.5: bert-naml layer-split through the Trainer, with item_lr (two
    LR groups), 2 steps of 2,048, dev through the caches."""
    import copy

    import numpy as np
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager

    cfg = copy.deepcopy(BERT_TRAIN_CFG)
    cfg["config"]["use_fast_eval"] = True
    policy = {**RUN_POLICY, "epoch": 1, "epoch_batch": LM_TRAINER_STEPS,
              "item_lr": TRAIN_LR / 10}
    m = Manager(model_cfg=cfg, exp_cfg={"policy": policy}, data=data,
                device=device, seed=0)
    tr, timer = _timed_trainer(m, lm_cache_root=None)
    rec = {"path": "bert-naml Trainer, layer-split", "policy": policy}
    _zero_counts()
    t0 = time.perf_counter()
    tr.init()
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["cache_launches"] = _counts()
    _zero_counts()
    t0 = time.perf_counter()
    out = tr.train()
    torch.cuda.synchronize()
    rec["train_s"] = time.perf_counter() - t0
    rec["launches"] = _counts()
    rec["best_dev"] = out["best_dev"]
    rec["epochs"] = tr.epochs
    rec["step_ms"] = [s * 1e3 for s in timer.samples["step"]]
    names = {id(p): n for n, p in m.model.named_parameters()}
    groups = {g["name"]: sorted(names[id(p)] for p in g["params"])
              for g in tr.optimizer.param_groups}
    rec["group_sizes"] = {k: len(v) for k, v in groups.items()}
    lora = sorted(n for n, p in m.model.named_parameters()
                  if p.requires_grad and n.startswith("item_op.lm.")
                  and ".lora_" in n)
    op = m.model.item_op
    cache = m.cache
    item_pages = len(cache.pages(cache.num_items))
    upper = op.num_hidden_layers - op.resolved_tune_from
    n_pages = -(-data.num_items // m.model.item_page_size)
    steps = tr.global_step
    rec["expected_launches"] = {
        "packed_attention": steps * 2 * upper * n_pages + upper * item_pages,
        "packed_attention_backward": steps * upper * n_pages,
        "additive_pool": steps * (2 * n_pages + 1) + _eval_pages(m),
        "dropout_keep_mask": 0}
    problems = []
    if groups.get("item") != lora:
        problems.append("the item LR group is not the LoRA of lm")
    if rec["launches"] != rec["expected_launches"]:
        problems.append("kernel launches")
    if steps != LM_TRAINER_STEPS or not all(
            np.isfinite(e["loss"]) for e in tr.epochs) or not np.isfinite(
            rec["best_dev"]):
        problems.append("losses or dev not finite")
    if problems:
        raise RuntimeError(f"bert-naml Trainer failed ({problems}): {rec}")
    del m, tr, cache
    torch.cuda.empty_cache()
    return rec


# the models 6.6 trains through the CLI: the flagship and one of the news
# zoo (its GRU user encoder on cuDNN)
CLI_MODELS = ("naml", "lstur")


def run_cli(tmp, models=CLI_MODELS) -> dict:
    """6.6 and 8.3: the CLI at `make smoke`'s geometry on the card:
    process, then train each of `models` (2 epochs of 4 batches of 16,
    hidden 16), from a temporary working directory; a result CSV each must
    exist. Needs PyYAML (the configs are YAML)."""
    import importlib.util

    rec = {"path": "CLI (make smoke geometry)", "models": list(models)}
    rec["yaml"] = importlib.util.find_spec("yaml") is not None
    if not rec["yaml"]:
        rec["outcome"] = "not run: PyYAML is not installed here"
        return rec
    from legommenders_tpu_torch import process, trainer

    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        data_dir = os.path.join(tmp, "data", "synthetic")
        process.main(["--data", "synthetic", "--save_dir", data_dir])
        rec["results"] = {}
        for model in models:
            rec["results"][model] = trainer.main([
                "--data", "synthetic", "--model", model, "--epoch", "2",
                "--epoch_batch", "4", "--batch_size", "16",
                "--hidden_size", "16", "--data_dir", data_dir])
        rec["s"] = time.perf_counter() - t0
        csvs = sorted(os.path.join(d, f) for d, _, fs in
                      os.walk(os.path.join(tmp, "checkpoints")) for f in fs
                      if f.endswith(".csv"))
    finally:
        os.chdir(cwd)
    if len(csvs) != len(models):
        raise RuntimeError(f"CLI: expected {len(models)} result CSVs, "
                           f"found {csvs}")
    rec["csv"] = {}
    for path in csvs:
        with open(path) as f:
            rec["csv"][os.path.basename(os.path.dirname(path))] = \
                f.read().splitlines()
    rec["outcome"] = "ran"
    return rec


# phase 7: the news zoo and the catalog gradient plans
ZOO_MODELS = ("nrms", "lstur", "fastformer", "miner")
ZOO_STEPS = 4
# each zoo path's pool shapes at full width (D 64), L as the inputers give
# it: LSTUR pools each column alone (category L 1, title 30) at H 256; NRMS's
# items carry a [SEP] after each column (30 + 1 + 1 + 1 = 33), H 256, and
# its users are NAML's user pool (50, 256); Fastformer's and MINER's items
# are the two columns' 31 slots and Fastformer's users 50, at H 64
ZOO_POOLS = {"lstur category": (1, 256, "item"),
             "lstur title": (30, 256, "item"),
             "nrms item": (33, 256, "item"),
             "fastformer/miner item": (31, 64, "item"),
             "fastformer user": (50, 64, "user")}
# the zoo models train and evaluate at the training batch: eval batches of
# 8,192, so MINER's full forwards encode the catalog once a page
ZOO_EXP = {"policy": {"dtype": "bf16", "batch_size": TRAIN_BATCH}}
# the NAML gradient with the plans against without them: f32 within 1e-5 of
# each tensor's largest value (the sums' order differs), bf16 within 2e-2
PLAN_F32_TOL, PLAN_BF16_TOL = 1e-5, 2e-2
PLAN_PROFILE_STEPS = 3


def zoo_cfg(name: str) -> dict:
    """config/model/<name>.yaml at its defaults, through the port's parser
    (hidden 64, 8 heads, 3 layers, 32 context codes of 200, 4 negatives)."""
    from legommenders_tpu_torch.config import parser

    return parser.parse_four_way(
        {"model": name}, config_root=os.path.join(ROOT, "config")
    ).raw()["model"]


def _pools_of(module) -> int:
    """The pool launches one call of `module` makes: its AdditiveAttention
    modules, each called once (none without a module: an id-only model's
    item side)."""
    from legommenders_tpu_torch.models.common import AdditiveAttention

    if module is None:
        return 0
    return sum(isinstance(m, AdditiveAttention) for m in module.modules())


def _plans_live(model) -> dict:
    from legommenders_tpu_torch.ops import catalog_grad

    t = catalog_grad.last_trace
    return {"live": sorted(t["live"]), "dead": list(t["dead"]),
            "history": t["history"],
            "all_live": (set(t["live"]) == set(model.catalog_plans or ())
                         and not t["dead"] and t["history"])}


def run_zoo_model(name: str, data, device) -> dict:
    """7.2: one zoo model from its YAML at full width, bf16: Tester.test()
    (the caches, or full forwards for MINER, whose user operator refuses
    caching), the first 2,048 served item reprs against the same model with
    its kernels patched out, 4 fused training steps; every pool launch
    held against the count the modules give; the plans live."""
    from unittest import mock

    import numpy as np
    import torch
    import legommenders_tpu_torch.models.common as common
    from legommenders_tpu_torch.ops.additive import additive_pool_reference
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {"path": name}
    t0 = time.perf_counter()
    m = Manager(model_cfg=zoo_cfg(name), exp_cfg=ZOO_EXP, data=data,
                device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    model = m.model
    rec["operators"] = [type(model.item_op).__name__,
                        type(model.user_op).__name__,
                        type(model.predictor).__name__]
    item_pools, user_pools = _pools_of(model.item_op), _pools_of(model.user_op)
    rec["pools_per_encode"] = {"item": item_pools, "user": user_pools}

    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["test_launches"] = _counts()
    ev = tester.evaluator
    if m.cache is not None:
        cache = m.cache
        rec["eval"] = "cached"
        rec["item_pages"] = len(cache.pages(cache.num_items))
        rec["user_pages"] = len(cache.pages(cache.num_users))
        want_pools = (rec["item_pages"] * item_pools
                      + rec["user_pages"] * user_pools)
        item_repr = cache.item_repr[:REPR_ROWS]
    else:
        rec["eval"] = "full forward"
        ph = ev.phase("test")
        P, S = ev.batch_size, data.history_matrix().shape[1]
        if data.num_items > 2 * P * (1 + S):
            raise RuntimeError(f"{name}: full-forward pages were expected "
                               f"to encode the catalog once each")
        rec["pages"] = -(-ph.n // P)
        want_pools = rec["pages"] * (item_pools + user_pools)
        with torch.inference_mode():
            item_repr = model.encode_item_content(
                {c: a[:REPR_ROWS] for c, a in m.contents.columns.items()})
    rec["expected_test_launches"] = {
        "additive_pool": want_pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    with mock.patch.object(common, "additive_pool", additive_pool_reference), \
            torch.inference_mode():
        item_ref = torch.cat([
            model.encode_item_content(
                {c: a[s:min(s + 512, REPR_ROWS)]
                 for c, a in m.contents.columns.items()})
            for s in range(0, REPR_ROWS, 512)])
    err = (item_repr.float() - item_ref.float()).abs().max()
    rec["item_repr_shape"] = [data.num_items, int(item_repr.shape[-1])]
    rec["item_repr_rel_err"] = float(err / item_ref.float().abs().max())
    rec["item_repr_finite"] = bool(torch.isfinite(item_repr.float()).all())
    rec["train"], dp = _train_steps(m, data, device, ZOO_STEPS)
    rec["expected_launches_per_step"] = {
        "additive_pool": item_pools + user_pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}

    problems = []
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    if rec["test_launches"] != rec["expected_test_launches"]:
        problems.append("test launches")
    if rec["train"]["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("training launches")
    if not rec["item_repr_finite"] or rec["item_repr_rel_err"] > BF16_REL_TOL:
        problems.append("item reprs disagree with the plain path")
    if not rec["train"]["plans"]["all_live"]:
        problems.append("catalog-grad plans not live")
    if (m.cache is None) != (name == "miner"):
        problems.append("caching")
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    del m, tester, ev, model, item_repr, item_ref, dp
    torch.cuda.empty_cache()
    return rec


def _plan_scale(name: str, grads: dict):
    """The largest value a gradient is held against: its own, or for a
    bias the larger of its own and its layer's weight's (a pool's
    proj_kernel for its proj_bias). A pool's proj_bias gradient is zero to
    first order (the softmax backward's weights sum to zero over the
    positions, tanh' ~1 near the init): the rounding residue of the terms
    the weight's gradient sums too, which another order of sums moves by a
    large share of itself."""
    ref = name
    if name.endswith("proj_bias"):
        ref = name[:-len("proj_bias")] + "proj_kernel"
    elif name.endswith(".bias"):
        ref = name[:-len("bias")] + "weight"
    return max(grads[name].abs().max().item(),
               grads[ref].abs().max().item(), 1e-30)


def run_naml_plans(data, device) -> dict:
    """7.3: NAML's gradients on one batch with the plans and with
    catalog_plans and catalog_history_plan set to None, at f32 and bf16
    (the same dropout generator: the plans draw nothing; both backward
    passes `deterministic`, so the comparison holds the two sums' orders,
    not the atomics' order of the run); then the bf16 training step both
    ways, timed and profiled."""
    import torch
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline, step_generator,
    )
    from legommenders_tpu_torch.runtime import steps
    from legommenders_tpu_torch.runtime.manager import Manager

    rec = {"path": "naml catalog-grad plans"}
    problems = []
    for dtype, tol in (("f32", PLAN_F32_TOL), ("bf16", PLAN_BF16_TOL)):
        m = Manager(model_cfg=MODEL_CFG,
                    exp_cfg={"policy": {"dtype": dtype}}, data=data,
                    device=device, seed=0)
        dp = DeviceTrainPipeline(data, batch_size=TRAIN_BATCH, seed=0,
                                 device=device)
        batch = dp.assemble(next(dp.epoch_indices(shuffle=False)),
                            step_generator(0, 0, device))
        model = m.model
        loss_fn = steps.make_loss_fn(model, m.contents.columns, True)
        grads, losses = {}, {}
        plans = model.catalog_plans, model.catalog_history_plan
        for side in ("plans", "plain"):
            if side == "plain":
                model.catalog_plans = model.catalog_history_plan = None
            model.zero_grad(set_to_none=True)
            with deterministic():
                loss = loss_fn(batch, step_generator(0, 1, device))
                loss.backward()
            losses[side] = loss.item()
            grads[side] = {n: p.grad.float().clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}
            if side == "plans":
                rec[f"{dtype}_plans"] = _plans_live(model)
        model.catalog_plans, model.catalog_history_plan = plans
        errs = {n: (g - grads["plain"][n]).abs().max().item()
                / _plan_scale(n, grads["plain"])
                for n, g in grads["plans"].items()}
        own = {n: (g - grads["plain"][n]).abs().max().item()
               / max(grads["plain"][n].abs().max().item(), 1e-30)
               for n, g in grads["plans"].items()}
        rec[f"{dtype}_loss"] = losses
        rec[f"{dtype}_rel_err"] = errs
        rec[f"{dtype}_rel_err_own_max"] = own
        rec[f"{dtype}_max_rel_err"] = max(errs.values())
        if grads["plans"].keys() != grads["plain"].keys():
            problems.append(f"{dtype}: gradients of different tensors")
        problems += [f"{dtype} {n}" for n, e in errs.items() if e > tol]
        if not rec[f"{dtype}_plans"]["all_live"]:
            problems.append(f"{dtype}: plans not live")
        if dtype == "bf16":
            for side in ("plans", "plain"):
                if side == "plain":
                    model.catalog_plans = model.catalog_history_plan = None
                rec[f"step_{side}"], _ = _train_steps(m, data, device,
                                                      PLAN_PROFILE_STEPS)
            model.catalog_plans, model.catalog_history_plan = plans
        del m, dp, model, grads, batch
        torch.cuda.empty_cache()
    if problems:
        raise RuntimeError(f"NAML with the plans disagrees with the plain "
                           f"backward ({problems}): {rec}")
    return rec


# phase 8: the CTR zoo
CTR_HEADS = ("dnn", "pnn", "deepfm", "dcn", "dcnv2", "gdcn", "autoint",
             "masknet", "finalmlp", "din")
CTR_MODELS = tuple(f"{h}_{side}" for h in CTR_HEADS
                   for side in ("id", "text")) + (
    "naml_id", "nrms_id", "miner_id", "bst_text")
CTR_STEPS = 4
# (N, H) of the user pools at L 50, D 64: the id models' Ada pool (H 256)
# over a training step's users and over a full-forward test page's (the
# eval batch, 4 x 2,048); bst_text's Transformer pool (H 64) over a
# training step's users (its test pools pages of 512 users, phase 7.1)
CTR_POOLS = {"ctr step users": (TRAIN_BATCH, 256),
             "ctr test page users": (4 * TRAIN_BATCH, 256),
             "bst_text step users": (TRAIN_BATCH, 64)}
CTR_CLI_MODELS = ("dcn_id", "din_text")


def run_ctr_model(name: str, data, device) -> dict:
    """8.2: one CTR-zoo YAML at its defaults, bf16: Tester.test() (the
    caches, or full forwards for the id-only models and the null user
    operator), a pooling model's test scores against the same model with
    its kernels patched out, 4 fused training steps; every pool launch held
    against the count the modules give."""
    from unittest import mock

    import numpy as np
    import torch
    import legommenders_tpu_torch.models.common as common
    from legommenders_tpu_torch.ops.additive import additive_pool_reference
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {"path": name}
    t0 = time.perf_counter()
    m = Manager(model_cfg=zoo_cfg(name), exp_cfg=ZOO_EXP, data=data,
                device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    model = m.model
    rec["operators"] = [type(x).__name__ if x is not None else None
                        for x in (model.item_op, model.user_op,
                                  model.predictor)]
    rec["ranking"] = not m.lego_cfg.use_neg_sampling
    item_pools = _pools_of(model.item_op) if model.item_op else 0
    user_pools = _pools_of(model.user_op)
    rec["pools_per_encode"] = {"item": item_pools, "user": user_pools}

    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["test_launches"] = _counts()
    ev = tester.evaluator
    ph = ev.phase("test")
    rec["rows"] = ph.n
    if m.cache is not None:
        cache = m.cache
        rec["eval"] = "cached"
        rec["item_pages"] = len(cache.pages(cache.num_items))
        rec["user_pages"] = len(cache.pages(cache.num_users))
        want_pools = (rec["item_pages"] * item_pools
                      + rec["user_pages"] * user_pools)
    else:
        rec["eval"] = "full forward"
        P, S = ev.batch_size, data.history_matrix().shape[1]
        if item_pools and data.num_items > 2 * P * (1 + S):
            raise RuntimeError(f"{name}: full-forward pages were expected "
                               f"to encode the catalog once each")
        rec["pages"] = -(-ph.n // P)
        want_pools = rec["pages"] * (item_pools + user_pools)
    rec["expected_test_launches"] = {
        "additive_pool": want_pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    score = (ev.score_phase_device if m.cache is not None
             else ev.score_phase_device_full)
    scores = score("test").float()
    rec["scores_finite"] = bool(torch.isfinite(scores).all())
    if item_pools + user_pools:
        # the caches are rebuilt without the kernel; nothing reads them
        # after this
        with mock.patch.object(common, "additive_pool",
                               additive_pool_reference):
            if m.cache is not None:
                m.cache.cache()
            plain = score("test").float()
        rec["score_rel_err"] = float((scores - plain).abs().max()
                                     / plain.abs().max())
    rec["train"], dp = _train_steps(m, data, device, CTR_STEPS)
    rec["expected_launches_per_step"] = {
        "additive_pool": item_pools + user_pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}

    problems = []
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    if rec["test_launches"] != rec["expected_test_launches"]:
        problems.append("test launches")
    if rec["train"]["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("training launches")
    if not rec["scores_finite"]:
        problems.append("scores not finite")
    if rec.get("score_rel_err", 0.0) > BF16_REL_TOL:
        problems.append("scores disagree with the plain path")
    if model.use_item_content and not rec["train"]["plans"]["all_live"]:
        problems.append("catalog-grad plans not live")
    if rec["ranking"] != (name not in ("naml_id", "nrms_id", "miner_id",
                                       "bst_text")):
        problems.append("training mode")
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    del m, tester, ev, model, dp
    torch.cuda.empty_cache()
    return rec


# phase 9: the decoder LMs
# llama-naml (config/model/llama-naml.yaml at its defaults: Llama1, 32 layers
# of 32 heads of 128, d 4096, SwiGLU int(4096 * 8 / 3) = 10,922, rope theta
# 1e4, bf16, LoRA r 32 folded, fused attention, compact inputer): serving in
# full-LM mode cut from 32 layers to 16 (the time limit: with phase 10 the
# whole run passed 900 s), to 8 since phase 12, to 4 with phase 15 and
# to 2 since phase 15's f32 pp ranks;
# training layer-split cut to 4 layers at tune_from 2 (the two trained
# layers and the trainable slice's shapes as at 32 layers and tune_from
# 30; the cache builds 2 layers, not 30: 14 from phase 12, 6 while phase
# 15 was added, 2 since phase 15's f32 pp ranks),
# pages of 512 under full remat, as bench_lm.py trains BERT at 10 of 12.
# glm-naml at GLM's full width (d 4096, 32 heads over 2 kv heads, SwiGLU
# 13,696) cut from 28 layers to 4 at tune_from 2, to 3 (one trained
# layer) since phase 16, to fit the time limit;
# opt-naml at OPTBase (12 layers, d 768, 12 heads) at tune_from 10 with
# hidden dropout 0.1 (dropout_reuse).
LLAMA_TRAIN_LAYERS, LLAMA_TUNE_FROM, LLAMA_SERVING_LAYERS = 4, 2, 2
GLM_LAYERS, GLM_TUNE_FROM = 3, 2
OPT_TUNE_FROM = 10
# one timed step (2 before), for the time limit: llama-naml's takes
# 20.8 s at the Llama-7B width (NVIDIA H100 80GB HBM3 at 700 W)
DECODER_STEPS = 1
DECODER_EXP = {"policy": {"dtype": "bf16", "batch_size": TRAIN_BATCH}}
# the decoders' attention pages: 512 items of the compact inputer's
# title + category (L 31: 4 items a row, T 124) and of the layer-split
# cache, padded to L 32 (T 128): 128 rows; Llama and GLM 32 heads of 128,
# OPT 12 of 64 (tests/test_torch_decoder_models.py checks these against
# the models)
DECODER_PAGES = {
    "llama serving": dict(items=512, L=31, D=4096, heads=32, train=False),
    "llama training": dict(items=512, L=32, D=4096, heads=32, train=True),
    "opt serving": dict(items=512, L=31, D=768, heads=12, train=False),
    "opt training": dict(items=512, L=32, D=768, heads=12, train=True),
}
# gradients of the trainable slice on one batch of this many impressions,
# every candidate and click encoded per occurrence
PRECISION_BATCH = 64


def decoder_cfg(name: str, **item_config) -> dict:
    """config/model/<name>.yaml at its defaults through the port's parser,
    with `item_config` over its item_config."""
    cfg = zoo_cfg(name)
    cfg["config"]["item_config"].update(item_config)
    return cfg


def decoder_attention_inputs(page: dict, dtype, device, seed: int):
    """q, k, v ~ N(0, 1) at a decoder page and the causal block-diagonal
    bias packed_mask_bias(..., causal=True) makes for items whose valid
    lengths are the fixture's (15..30 title tokens + category, first)."""
    import torch
    from legommenders_tpu_torch.models.lm.layers import (
        pack_items, packed_mask_bias,
    )

    items, L, Dm = page["items"], page["L"], page["D"]
    g = torch.Generator(device=device).manual_seed(seed)
    lens = torch.randint(16, 32, (items,), generator=g, device=device)
    mask = (torch.arange(L, device=device)[None] < lens[:, None]).int()
    _, mask_p, _ = pack_items(torch.zeros(items, L, 1, device=device), mask,
                              128 // L)
    B, T = mask_p.shape
    q, k, v, gr = (torch.randn(B, T, Dm, generator=g, device=device).to(dtype)
                   for _ in range(4))
    return q, k, v, packed_mask_bias(mask_p, L, dtype, causal=True)[:, 0], gr


# the f32 backward at head width 128 around the T its shared memory once
# capped (T 116 was taken, T 117 was not): 5 packed rows of 4 items of 29
# and of 3 items of 39, 4 heads of 128
F32_BWD_PAGES = {"T 116": dict(items=20, L=29, D=512, heads=4),
                 "T 117": dict(items=15, L=39, D=512, heads=4)}


def check_f32_backward_edges(device) -> list:
    """9.1: the f32 backward (attention_bwd_tf32) at F32_BWD_PAGES with the
    causal packed biases, at dropout 0 and TRAIN_DROPOUT (the plain
    backward given the mask kernel's mask), within F32_TOL."""
    import torch
    from legommenders_tpu_torch.ops.attention import (
        dropout_keep_mask, packed_attention_backward,
        reference_attention_backward,
    )

    out = []
    for name, page in F32_BWD_PAGES.items():
        q, k, v, bias, g = decoder_attention_inputs(page, torch.float32,
                                                    device, 17)
        (B, T, Dm), heads = q.shape, page["heads"]
        seed = torch.tensor([4242], dtype=torch.int32, device=device)
        for p in (0.0, TRAIN_DROPOUT):
            keep = dropout_keep_mask(heads, p, B, T, seed) if p else None
            with torch.no_grad():
                got = packed_attention_backward(heads, p, q, k, v, bias,
                                                seed, g)
                want = reference_attention_backward(heads, p, q, k, v, bias,
                                                    g, keep)
            rec = {"page": name, "B": B, "T": T, "heads": heads,
                   "dh": Dm // heads, "dropout": p,
                   "max_abs_err": max((a - b).abs().max().item()
                                      for a, b in zip(got, want)),
                   "finite": all(bool(torch.isfinite(a).all())
                                 for a in got)}
            out.append(rec)
            if not rec["finite"] or rec["max_abs_err"] > F32_TOL:
                raise RuntimeError(f"the f32 backward disagrees with its "
                                   f"plain version: {rec}")
    return out


def check_decoder_attention(name: str, device) -> dict:
    """9.1: the attention forward (and at a training page the backward) at
    a decoder page, dropout 0, against the plain versions in f32 (1e-5)
    and bf16 (2e-2 of the largest output), the bf16 kernels timed beside
    the plain versions, torch's SDPA with the float mask and the bounds;
    at a training page the f32 kernels (3xTF32, dh 128 at T 128) timed
    beside their bounds and SDPA at f32 too."""
    import torch
    from torch.nn import functional as F
    from legommenders_tpu_torch.ops.attention import (
        packed_attention, packed_attention_backward, reference_attention,
        reference_attention_backward,
    )

    page = DECODER_PAGES[name]
    heads, train = page["heads"], page["train"]
    res = {"page": name, "heads": heads}
    problems = []
    for dtype_name in ("f32", "bf16"):
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
        q, k, v, bias, g = decoder_attention_inputs(page, dtype, device, 13)
        B, T, Dm = q.shape
        res.update(B=B, T=T, D=Dm)
        dh = Dm // heads
        with torch.no_grad():
            pairs = [("out", packed_attention(heads, 0.0, q, k, v, bias),
                      reference_attention(heads, 0.0, q, k, v, bias))]
            if train:
                pairs += list(zip(("dq", "dk", "dv"),
                                  packed_attention_backward(
                                      heads, 0.0, q, k, v, bias, None, g),
                                  reference_attention_backward(
                                      heads, 0.0, q, k, v, bias, g)))
            torch.cuda.synchronize()
        for part, got, want in pairs:
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            res[f"{dtype_name}_{part}_max_abs_err"] = err
            res[f"{dtype_name}_{part}_rel_err"] = rel
            if not bool(torch.isfinite(got.float()).all()) or (
                    err > F32_TOL if dtype_name == "f32"
                    else rel > BF16_REL_TOL):
                problems.append(f"{dtype_name} {part}")
        if train and dtype_name == "f32":
            with torch.no_grad():
                res["f32_ms"] = time_ms(lambda: packed_attention(
                    heads, 0.0, q, k, v, bias), iters=20)
                res["f32_bwd_ms"] = time_ms(lambda: packed_attention_backward(
                    heads, 0.0, q, k, v, bias, None, g), iters=20)
            res["f32_bound_ms"], res["f32_bound_by"] = roof(
                4.0 * B * T * T * Dm,
                4 * B * T * Dm * 4 + B * T * T * bias.element_size(),
                "tf32x3")
            res["f32_bwd_bound_ms"], res["f32_bwd_bound_by"] = roof(
                10.0 * B * T * T * Dm,
                7 * B * T * Dm * 4 + B * T * T * bias.element_size(),
                "tf32x3")
            res["f32_bwd_cuda_core_bound_ms"] = roof(
                10.0 * B * T * T * Dm,
                7 * B * T * Dm * 4 + B * T * T * bias.element_size(),
                "f32")[0]
            # torch's SDPA at f32 with the float mask, forward + backward:
            # timed only
            qh32, kh32, vh32 = (t.view(B, T, heads, dh).transpose(1, 2)
                                .detach().requires_grad_(True)
                                for t in (q, k, v))
            gh32 = g.view(B, T, heads, dh).transpose(1, 2)
            res["f32_library_fwd_bwd_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qh32, kh32, vh32, attn_mask=bias[:, None]).backward(gh32),
                iters=5)
            del qh32, kh32, vh32, gh32
        del pairs
    if problems:
        raise RuntimeError(f"decoder attention disagrees with its plain "
                           f"version ({problems}): {res}")
    qh, kh, vh = (t.view(B, T, heads, dh).transpose(1, 2).detach()
                  .requires_grad_(train) for t in (q, k, v))
    gh = g.view(B, T, heads, dh).transpose(1, 2)
    mask4 = bias[:, None]
    with torch.no_grad():
        res["ms"] = time_ms(lambda: packed_attention(heads, 0.0, q, k, v,
                                                     bias), iters=20)
        res["plain_ms"] = time_ms(lambda: reference_attention(
            heads, 0.0, q, k, v, bias), iters=3)
        res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask4), iters=20)
    xb, bb = q.element_size(), bias.element_size()
    res["bound_ms"], res["bound_by"] = roof(
        4.0 * B * T * T * Dm, 4 * B * T * Dm * xb + B * T * T * bb, "bf16")
    res["bound_bytes"] = 4 * B * T * Dm * xb + B * T * T * bb
    if train:
        with torch.no_grad():
            res["bwd_ms"] = time_ms(lambda: packed_attention_backward(
                heads, 0.0, q, k, v, bias, None, g), iters=20)
            res["bwd_plain_ms"] = time_ms(
                lambda: reference_attention_backward(heads, 0.0, q, k, v,
                                                     bias, g), iters=3)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qh, kh, vh,
                                           attn_mask=mask4).backward(gh)

        res["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd, iters=10)
        res["bwd_bound_ms"], res["bwd_bound_by"] = roof(
            10.0 * B * T * T * Dm, 7 * B * T * Dm * xb + B * T * T * bb,
            "bf16")
        res["bwd_bound_bytes"] = 7 * B * T * Dm * xb + B * T * T * bb
    del q, k, v, bias, g, qh, kh, vh, gh
    torch.cuda.empty_cache()
    return res


def _page_profile(m, cache, pages: int) -> dict:
    """torch.profiler over `pages` item pages of the serving cache build
    (the Tester's own encode, page by page): the device's idle share and
    the top kernels of a decoder's serving pass."""
    import torch

    def run():
        with torch.inference_mode():
            for s, e in cache.pages(cache.num_items)[:pages]:
                m.model.encode_item_page(
                    {c: a[s:e] for c, a in cache.item_contents.items()})

    return profile_window(run)


def run_llama_serving(data, device) -> dict:
    """9.2: llama-naml in full-LM mode through Manager + Tester.test():
    every item through LLAMA_SERVING_LAYERS layers; the launch counts
    against the code's (attention once a layer a page, the pool once a
    page); the first 2,048 served
    reprs against the same model with its kernels patched out; one
    profiled stretch of 8 pages; peak memory."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {"path": "llama-naml serving (full LM)"}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = Manager(model_cfg=decoder_cfg(
        "llama-naml", num_hidden_layers=LLAMA_SERVING_LAYERS),
                exp_cfg=EXP_CFG,
                data=data, device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    op = m.model.item_op
    rec["layers"], rec["params"] = op.num_hidden_layers, sum(
        p.numel() for p in m.model.parameters())
    rec["param_gb"] = torch.cuda.memory_allocated() / 2 ** 30
    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["launches"] = _counts()
    cache = m.cache
    rec["item_pages"] = len(cache.pages(cache.num_items))
    rec["user_pages"] = len(cache.pages(cache.num_users))
    rec["expected_launches"] = {
        "additive_pool": rec["item_pages"] + rec["user_pages"],
        "packed_attention": op.num_hidden_layers * rec["item_pages"],
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    _repr_check(m, cache, rec)
    rec["profile"] = _page_profile(m, cache, 8)
    problems = []
    if rec["item_repr_shape"] != [data.num_items, 64] or \
            rec["user_repr_shape"] != [data.num_users, 64]:
        problems.append("repr shapes")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    for part in ("item", "user"):
        if not rec[f"{part}_repr_finite"]:
            problems.append(f"{part} reprs not finite")
        if rec[f"{part}_repr_rel_err"] > BF16_REL_TOL:
            problems.append(f"{part} reprs disagree with the plain path")
    if rec["launches"] != rec["expected_launches"]:
        problems.append("kernel launches")
    if problems:
        raise RuntimeError(f"llama-naml serving failed ({problems}): {rec}")
    del m, tester, cache, op
    torch.cuda.empty_cache()
    return rec


class _TrainableDtype:
    """Every module of a model but the frozen lower slice computing in
    `dtype` for the time of the block (the cached hidden states are cast
    to it as the upper slice reads them)."""

    def __init__(self, model, dtype):
        import torch

        lower = getattr(model.item_op, "lm_lower", None)
        skip = set(map(id, lower.modules())) if lower is not None else set()
        self.mods = [mod for mod in model.modules() if id(mod) not in skip
                     and isinstance(getattr(mod, "dtype", None), torch.dtype)]
        self.dtype = dtype

    def __enter__(self):
        self.saved = [mod.dtype for mod in self.mods]
        for mod in self.mods:
            mod.dtype = self.dtype

    def __exit__(self, *exc):
        for mod, dt in zip(self.mods, self.saved):
            mod.dtype = dt


def decoder_precision_check(m, dp, device) -> dict:
    """The trainable slice's gradients of a layer-split decoder (as trained
    by the timed steps, lora_B drawn non-zero) on one batch of
    PRECISION_BATCH impressions at dropout 0, every candidate and click
    encoded per occurrence through the upper layers, in four runs: the
    kernels (K16, twice) and their plain versions (P16) at bf16, and the
    kernels (K32) and their plain versions (P32) with the trained part at
    f32 (over the bf16 cache; K32 runs the f32 kernels (3xTF32), the
    backward at dh 128 and the training page's T 128). Gate per tensor: K16 within
    2e-2 of P16, or within half the plain path's own bf16 error (P16
    against P32) where that is larger (see precision_check); K32 within
    F32_GRAD_TOL (1e-4) of P32."""
    import torch
    from legommenders_tpu_torch.runtime.steps import step_generator

    t0 = time.perf_counter()
    model = m.model
    g = torch.Generator(device=device).manual_seed(5)
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "lora_r", 0) > 0:
                mod.lora_B.normal_(0.0, 0.05, generator=g)
    idx = next(dp.epoch_indices(shuffle=False))[:PRECISION_BATCH]
    batch = dp.assemble(idx, step_generator(0, 10 ** 6, device))
    saved = model.full_catalog_encode
    model.full_catalog_encode = "off"
    rec = {"batch": PRECISION_BATCH, "loss": {}}
    grads = {}
    try:
        for name, plain in (("K16", False), ("K16_again", False),
                            ("P16", True)):
            rec["loss"][name], grads[name] = _grads(m, batch, plain)
        with _TrainableDtype(model, torch.float32):
            rec["loss"]["K32"], grads["K32"] = _grads(m, batch, False)
            rec["loss"]["P32"], grads["P32"] = _grads(m, batch, True)
    finally:
        model.full_catalog_encode = saved
    pairs = {"K16_vs_P16": ("K16", "P16"), "P16_vs_P32": ("P16", "P32"),
             "K32_vs_P32": ("K32", "P32"),
             "K16_vs_P32": ("K16", "P32"),
             "K16_vs_K16_again": ("K16_again", "K16")}
    rec["rel_err"] = {k: _rel_errs(grads[a], grads[b])
                      for k, (a, b) in pairs.items()}
    rec["max_rel_err"] = {k: max(v.values())
                          for k, v in rec["rel_err"].items()}
    rec["bf16_limit"] = {n: max(BF16_REL_TOL, 0.5 * e) for n, e in
                         rec["rel_err"]["P16_vs_P32"].items()}
    rec["tensors"] = len(grads["P16"])
    rec["s"] = time.perf_counter() - t0
    problems = [n for n, e in rec["rel_err"]["K16_vs_P16"].items()
                if e > rec["bf16_limit"][n]]
    problems += [f"{n} (f32)" for n, e in rec["rel_err"]["K32_vs_P32"].items()
                 if e > F32_GRAD_TOL]
    if problems:
        raise RuntimeError(f"decoder training gradients disagree with the "
                           f"plain path ({problems}): {rec}")
    return rec


def run_decoder_training(name: str, cfg: dict, data, device,
                         test: bool, precision: bool) -> dict:
    """9.2 / 9.3: a decoder YAML in layer-split mode: the lower slice's
    cache (timed; tune_from launches of the attention a page), with `test`
    Tester.test() through the caches (the upper slice over the cached
    states) and its reprs against the plain path, then 1 warm and
    DECODER_STEPS timed fused steps of 2,048 with pages of 512 under full
    remat, and with `precision` one profiled; the launches per step
    against the code's (as bert-naml's); with `precision`
    decoder_precision_check."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {"path": f"{name} layer-split"}
    cfg["config"].update(item_page_size=512, item_page_remat="full",
                         use_fast_eval=test)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = Manager(model_cfg=cfg, exp_cfg=DECODER_EXP, data=data,
                device=device, seed=0)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    op = m.model.item_op
    upper = op.num_hidden_layers - op.resolved_tune_from
    rec.update(operator=type(op).__name__, layers=op.num_hidden_layers,
               tune_from=op.resolved_tune_from)
    _zero_counts()
    t0 = time.perf_counter()
    assert m.prepare_lm_cache(root=None)
    torch.cuda.synchronize()
    rec["cache_s"] = time.perf_counter() - t0
    rec["cache_launches"] = _counts()
    hid = m.contents.columns[LM_HIDDEN_KEY]
    rec["cache_shape"], rec["cache_dtype"] = list(hid.shape), str(hid.dtype)
    rec["cache_gb"] = hid.numel() * hid.element_size() / 2 ** 30
    del hid
    pages = -(-data.num_items // m.lego_cfg.cache_page_size)
    rec["expected_cache_launches"] = op.resolved_tune_from * pages
    problems = []
    if rec["cache_launches"]["packed_attention"] != \
            rec["expected_cache_launches"]:
        problems.append("cache-build launches")
    if test:
        _zero_counts()
        t0 = time.perf_counter()
        rec["metrics"] = Tester(m).test()
        torch.cuda.synchronize()
        rec["test_s"] = time.perf_counter() - t0
        rec["test_launches"] = _counts()
        cache = m.cache
        item_pages = len(cache.pages(cache.num_items))
        rec["expected_test_launches"] = {
            "additive_pool": item_pages + len(cache.pages(cache.num_users)),
            "packed_attention": upper * item_pages,
            "packed_attention_backward": 0, "dropout_keep_mask": 0}
        _repr_check(m, cache, rec)
        if rec["test_launches"] != rec["expected_test_launches"]:
            problems.append("test launches")
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0
                   for v in rec["metrics"].values()):
            problems.append("metrics not finite in [0, 1]")
        for part in ("item", "user"):
            if not rec[f"{part}_repr_finite"] or \
                    rec[f"{part}_repr_rel_err"] > BF16_REL_TOL:
                problems.append(f"{part} reprs")
        del cache
    rec["train"], dp = _train_steps(m, data, device, DECODER_STEPS,
                                    profile=precision)
    n_pages = -(-data.num_items // m.model.item_page_size)
    rec["expected_launches_per_step"] = {
        "packed_attention": 2 * upper * n_pages,
        "packed_attention_backward": upper * n_pages,
        "additive_pool": 2 * n_pages + 1, "dropout_keep_mask": 0}
    if rec["train"]["launches_per_step"] != \
            rec["expected_launches_per_step"]:
        problems.append("launches per step")
    if precision:
        rec["grad_check"] = decoder_precision_check(m, dp, device)
    del m, dp, op
    torch.cuda.empty_cache()
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    return rec


# phase 10: IISAN, the BERT zoo and the flatten (BST) user paths
# bert-iisan-naml at its YAML's defaults (BERT-base, 12 layers, d 768,
# layer_selection_step 2: layers 1, 3, ..., 11); llama-iisan-naml at the
# Llama-7B width (d 4096, 32 heads of 128, SwiGLU 10,922) cut from 32
# layers to 4 for the time limit (2 selected layers)
IISAN_MODELS = {"bert-iisan-naml": {}, "llama-iisan-naml":
                {"num_hidden_layers": 4}}
IISAN_STEPS = 4
# the BERT zoo at tune_from 10 of 12, as bert-naml trains in phase 5
BERT_ZOO_MODELS = ("bert-nrms", "bert-lstur", "bert-miner",
                   "bert-fastformer", "bert-dcn")
BERT_ZOO_TUNE_FROM, BERT_ZOO_STEPS, BERT_ZOO_PAGE = 10, 2, 512
# the flatten paths at their YAML defaults (hidden 64, 3 item and 3 user
# layers): the history cut to the clicks the user operator's positions
# take (33 slots a click: title 30, category, [ATTR_SEP], [SEP]; 1,024
# positions for the Transformer, 512 for Fastformer), and the largest
# training and eval batches that fit: (clicks, batch, eval batch)
FLATTEN_MODELS = {"flatten_transformer": (31, 128, 512),
                  "flatten_fastformer": (15, TRAIN_BATCH, 4 * TRAIN_BATCH)}
# flatten_transformer's Tester.test() over the dev and test rows of the
# first 1,000 of the 20,000 users (~24 full-forward pages of 512 at
# L 1,023; 2,000 users' 47 pages took 13.2 s, 4,000 users' 94 26.4 s and
# all 469 131.5 s on an NVIDIA H100 80GB HBM3 at 700 W), for the time
# limit (2,000 until phase 16): depth, not width
FLATTEN_TEST_USERS = {"flatten_transformer": 1000}
FLATTEN_STEPS = 4
# the flatten user pools (D 64, H 64) over a step's users and a test page
FLATTEN_POOLS = {f"{name} user": (slots, h) for name, slots, h in (
    ("flatten_transformer", 1023, 64), ("flatten_fastformer", 495, 64))}
PHASE10_CLI_MODELS = ("bert-iisan-naml", "flatten_transformer")


def cut_history(data, clicks: int, users=None):
    """The fixture with every history cut to its first `clicks` clicks, as
    a data config's user-column spec cuts it (LegoData.from_config); the
    item store and the training rows are shared. With `users`, the dev
    and test rows are those of the first `users` users only."""
    import numpy as np
    from legommenders_tpu_torch.data.dataset import LegoData

    hist = data.cm.history_col
    cut = data.users.view().truncate(hist, clicks)
    inters = data.inters
    if users is not None:
        inters = dict(inters)
        for phase in ("dev", "test"):
            rows = inters[phase]
            inters[phase] = rows.select(np.flatnonzero(
                rows[data.cm.user_col] < users))
    return LegoData(data.items, cut, inters, data.cm,
                    data.item_inputs, user_inputs=[(hist, clicks)],
                    name=data.name)


def _expected_lm_test_launches(m, upper: int) -> dict:
    """A layer-split LM model's Tester.test() launches: through the repr
    caches (the upper layers once an item page, its pools once a page),
    or by full forwards (each eval page encodes the catalog in pages of
    item_page_size through the upper layers, and its users)."""
    model = m.model
    item_pools, user_pools = _pools_of(model.item_op), _pools_of(model.user_op)
    cache, P = m.cache, model.item_page_size
    if cache is not None:
        # a cache page longer than item_page_size is encoded in pages
        item_pages = sum(-(-(e - s) // P) if 0 < P < e - s else 1
                         for s, e in cache.pages(cache.num_items))
        user_pages = len(cache.pages(cache.num_users))
        return {"additive_pool": item_pages * item_pools
                + user_pages * user_pools,
                "packed_attention": upper * item_pages,
                "packed_attention_backward": 0, "dropout_keep_mask": 0}
    ev = m.evaluator()
    pages = -(-ev.phase("test").n // ev.batch_size)
    n_pages = -(-m.data.num_items // P)
    return {"additive_pool": pages * (n_pages * item_pools + user_pools),
            "packed_attention": pages * upper * n_pages,
            "packed_attention_backward": 0, "dropout_keep_mask": 0}


def _iisan_states_check(m, rec):
    """The IISAN cache's first REPR_ROWS items' states against the same
    frozen LM with its attention kernel patched out for the plain version:
    the largest error over the largest value."""
    from unittest import mock

    import torch
    import legommenders_tpu_torch.models.lm.layers as lm_layers
    from legommenders_tpu_torch.models.operators.lm_ops import (
        LM_HIDDEN_KEY, LM_MASK_KEY,
    )
    from legommenders_tpu_torch.runtime.lm_cache import build_iisan_states

    cols = {c: a[:REPR_ROWS] for c, a in m.contents.columns.items()
            if c not in (LM_HIDDEN_KEY, LM_MASK_KEY)}
    sel = m.model.item_op.get_selected_layers()
    with mock.patch.object(lm_layers, "packed_attention",
                           _plain_attention()), torch.inference_mode():
        want = build_iisan_states(m.model, cols,
                                  m.lego_cfg.cache_page_size)[:, sel]
    got = m.contents.columns[LM_HIDDEN_KEY][:REPR_ROWS]
    rec["states_rel_err"] = float((got - want).abs().max()
                                  / want.abs().max())
    rec["states_finite"] = bool(torch.isfinite(got).all())


def run_iisan_model(name: str, data, device) -> dict:
    """10.2: an IISAN YAML (bf16, seed 0): the cache build over every item
    through all the LM's layers (its attention launches counted), its
    states against the plain attention's, Tester.test() through the caches
    (the side network over the cached states; the served reprs against
    the patched-out model), IISAN_STEPS fused steps of 2,048 (the LM never
    runs: the user pool only) and, for bert-iisan-naml, one Trainer run."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {"path": name}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = Manager(model_cfg=decoder_cfg(name, **IISAN_MODELS[name]),
                exp_cfg=DECODER_EXP, data=data, device=device, seed=0)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    op = m.model.item_op
    rec.update(operator=type(op).__name__, layers=op.num_hidden_layers,
               selected=op.get_selected_layers(), width=op.input_dim)
    _zero_counts()
    t0 = time.perf_counter()
    assert m.prepare_lm_cache(root=None)
    torch.cuda.synchronize()
    rec["cache_s"] = time.perf_counter() - t0
    rec["cache_launches"] = _counts()
    states = m.contents.columns[LM_HIDDEN_KEY]
    rec["cache_shape"], rec["cache_dtype"] = (list(states.shape),
                                              str(states.dtype))
    del states
    pages = -(-data.num_items // m.lego_cfg.cache_page_size)
    rec["expected_cache_launches"] = {
        "packed_attention": op.num_hidden_layers * pages,
        "additive_pool": 0, "packed_attention_backward": 0,
        "dropout_keep_mask": 0}
    _iisan_states_check(m, rec)
    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = Tester(m).test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["test_launches"] = _counts()
    rec["expected_test_launches"] = _expected_lm_test_launches(m, 0)
    _repr_check(m, m.cache, rec)
    rec["train"], dp = _train_steps(m, data, device, IISAN_STEPS)
    rec["expected_launches_per_step"] = {
        "additive_pool": _pools_of(m.model.user_op), "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    problems = []
    if rec["cache_launches"] != rec["expected_cache_launches"]:
        problems.append("cache-build launches")
    if rec["cache_shape"] != [data.num_items, len(rec["selected"]),
                              op.input_dim]:
        problems.append("cache shape")
    if not rec["states_finite"] or rec["states_rel_err"] > BF16_REL_TOL:
        problems.append("states disagree with the plain attention's")
    if rec["test_launches"] != rec["expected_test_launches"]:
        problems.append("test launches")
    if rec["train"]["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("launches per step")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    for part in ("item", "user"):
        if not rec[f"{part}_repr_finite"] or \
                rec[f"{part}_repr_rel_err"] > BF16_REL_TOL:
            problems.append(f"{part} reprs")
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    del dp
    if name == "bert-iisan-naml":
        rec["trainer"] = _iisan_trainer(m)
    del m, op
    torch.cuda.empty_cache()
    return rec


def _iisan_trainer(m) -> dict:
    """One Trainer run of an IISAN model: LM_TRAINER_STEPS steps of 2,048
    on device batches, dev through the caches (the Trainer builds the
    IISAN cache again, on the device)."""
    import numpy as np
    import torch

    m.policy.update(RUN_POLICY, epoch=1, epoch_batch=LM_TRAINER_STEPS,
                    device_batching=True)
    tr, timer = _timed_trainer(m, lm_cache_root=None)
    _zero_counts()
    t0 = time.perf_counter()
    tr.init()
    out = tr.train()
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t0, "launches": _counts(),
           "best_dev": out["best_dev"], "steps": tr.global_step,
           "step_ms": [x * 1e3 for x in timer.samples["step"]]}
    # the cache is built once more from the same weights (its attention
    # launches), then steps (the user pool) and the dev pass
    pages = -(-m.data.num_items // m.lego_cfg.cache_page_size)
    rec["expected_launches"] = {
        "packed_attention": m.model.item_op.num_hidden_layers * pages,
        "additive_pool": tr.global_step * _pools_of(m.model.user_op)
        + len(m.cache.pages(m.cache.num_users)),
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    if rec["launches"] != rec["expected_launches"] or not np.isfinite(
            rec["best_dev"]) or tr.global_step != LM_TRAINER_STEPS:
        raise RuntimeError(f"IISAN Trainer failed: {rec}")
    return rec


def run_bert_zoo_model(name: str, data, device) -> dict:
    """10.3: a BERT zoo YAML (bf16, seed 0) layer-split at tune_from 10:
    the cache (10 layers), Tester.test() (through the caches, or by full
    forwards for MINER, whose user operator refuses caching), the served
    item reprs against the patched-out model, BERT_ZOO_STEPS fused steps of
    2,048 with pages of 512 under full remat; every launch count against
    the code's."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    cfg = zoo_cfg(name)
    cfg["config"]["item_config"]["tune_from"] = BERT_ZOO_TUNE_FROM
    cfg["config"].update(item_page_size=BERT_ZOO_PAGE,
                         item_page_remat="full")
    rec = {"path": name}
    torch.cuda.reset_peak_memory_stats()
    m = Manager(model_cfg=cfg, exp_cfg=ZOO_EXP, data=data, device=device,
                seed=0)
    model, op = m.model, m.model.item_op
    upper = op.num_hidden_layers - op.resolved_tune_from
    rec["operators"] = [type(x).__name__ for x in (
        model.item_op, model.user_op, model.predictor)]
    _zero_counts()
    t0 = time.perf_counter()
    assert m.prepare_lm_cache(root=None)
    torch.cuda.synchronize()
    rec["cache_s"] = time.perf_counter() - t0
    rec["cache_launches"] = _counts()["packed_attention"]
    pages = -(-data.num_items // m.lego_cfg.cache_page_size)
    rec["expected_cache_launches"] = op.resolved_tune_from * pages
    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = Tester(m).test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["eval"] = "cached" if m.cache is not None else "full forward"
    rec["test_launches"] = _counts()
    rec["expected_test_launches"] = _expected_lm_test_launches(m, upper)
    if m.cache is not None:
        _repr_check(m, m.cache, rec)
    rec["train"], dp = _train_steps(m, data, device, BERT_ZOO_STEPS,
                                    profile=False)
    n_pages = -(-data.num_items // model.item_page_size)
    rec["expected_launches_per_step"] = {
        "packed_attention": 2 * upper * n_pages,
        "packed_attention_backward": upper * n_pages,
        "additive_pool": 2 * n_pages * _pools_of(op)
        + _pools_of(model.user_op), "dropout_keep_mask": 0}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    problems = []
    if rec["cache_launches"] != rec["expected_cache_launches"]:
        problems.append("cache-build launches")
    if rec["test_launches"] != rec["expected_test_launches"]:
        problems.append("test launches")
    if rec["train"]["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("launches per step")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    for part in ("item", "user") if m.cache is not None else ():
        if not rec[f"{part}_repr_finite"] or \
                rec[f"{part}_repr_rel_err"] > BF16_REL_TOL:
            problems.append(f"{part} reprs")
    if (m.cache is None) != (name == "bert-miner"):
        problems.append("caching")
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    del m, model, op, dp
    torch.cuda.empty_cache()
    return rec


def run_flatten_model(name: str, data, device) -> dict:
    """10.4: a flatten YAML at its defaults (bf16, seed 0) over the fixture
    with its history cut (FLATTEN_MODELS): Tester.test() by full forwards
    (a page of the eval batch encodes its candidates and its users'
    flattened histories: two pools a page, the user pool over L = clicks x
    33 on the long-sequence kernel), the first two pages' scores against
    the same model with its kernels patched out, FLATTEN_STEPS fused steps
    (two pools a step); peak memory."""
    from unittest import mock

    import numpy as np
    import torch
    import legommenders_tpu_torch.models.common as common
    from legommenders_tpu_torch.ops.additive import additive_pool_reference
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    clicks, batch, eval_batch = FLATTEN_MODELS[name]
    cut = cut_history(data, clicks, FLATTEN_TEST_USERS.get(name))
    rec = {"path": name, "clicks": clicks, "batch": batch,
           "eval_batch": eval_batch,
           "test_users": FLATTEN_TEST_USERS.get(name)}
    exp = {"policy": {"dtype": "bf16", "batch_size": batch,
                      "eval_batch_size": eval_batch}}
    torch.cuda.reset_peak_memory_stats()
    m = Manager(model_cfg=zoo_cfg(name), exp_cfg=exp, data=cut,
                device=device, seed=0)
    model = m.model
    rec["operators"] = [type(x).__name__ for x in (
        model.item_op, model.user_op, model.predictor)]
    rec["seq_len"] = model.user_inputer.seq_len(clicks)
    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = Tester(m).test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["test_launches"] = _counts()
    rec["test_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ev = m.evaluator()
    rec["pages"] = -(-ev.phase("test").n // eval_batch)
    pools = _pools_of(model.item_op) + _pools_of(model.user_op)
    rec["expected_test_launches"] = {
        "additive_pool": rec["pages"] * pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    # the first two pages' scores through the kernels and without them
    sub = ev.phase("test")
    n = min(2 * eval_batch, sub.n)
    sub.n = n
    with torch.inference_mode():
        scores = ev.score_phase_device_full("test").float()
        with mock.patch.object(common, "additive_pool",
                               additive_pool_reference):
            plain = ev.score_phase_device_full("test").float()
    rec["score_rows"] = n
    rec["score_rel_err"] = float((scores - plain).abs().max()
                                 / plain.abs().max())
    rec["scores_finite"] = bool(torch.isfinite(scores).all())
    del ev, sub, scores, plain
    rec["train"], dp = _train_steps(m, cut, device, FLATTEN_STEPS,
                                    batch=batch)
    rec["expected_launches_per_step"] = {
        "additive_pool": pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    problems = []
    if rec["test_launches"] != rec["expected_test_launches"]:
        problems.append("test launches")
    if rec["train"]["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("launches per step")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    if not rec["scores_finite"] or rec["score_rel_err"] > BF16_REL_TOL:
        problems.append("scores disagree with the plain path")
    if m.cache is not None:
        problems.append("caching")
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    del m, model, dp, cut
    torch.cuda.empty_cache()
    return rec


# the phases `--phases` may name (the device, the build and the data run
# always)
PHASES = {3: "kernels", 4: "serving", 5: "training", 6: "run loop",
          7: "news zoo", 8: "CTR zoo", 9: "decoders",
          10: "IISAN, BERT zoo, flatten",
          11: "LM knobs, semantic IDs, processed MIND",
          12: "drivers and data parallel",
          13: "model parallel and catalog_parallel",
          14: "sequence and pipeline parallel",
          15: "mesh combinations and catalog-parallel evaluation",
          16: "scaling sweep and multi-chip dry run"}


class phase_timer:
    """Logs a `[phase]` line with the wall seconds of its block and the
    share of them the profiler's host-side summaries took."""

    def __init__(self, number, name: str):
        self.number, self.name = number, name

    def __enter__(self):
        self.t0, self.s0 = time.perf_counter(), PROFILE_SUMMARY_S[0]
        return self

    def __exit__(self, *exc):
        s = time.perf_counter() - self.t0
        summ = PROFILE_SUMMARY_S[0] - self.s0
        log(f"[phase] {self.number} {self.name}: {s:.2f} s (profiler "
            f"summaries {summ:.2f} s){' FAILED' if exc[0] else ''}")
        TIMES[str(self.number)] = s


TIMES = {}


def parse_phases(argv) -> set:
    """The phases to run: all without arguments, else `--phases 3,9`."""
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "CUDA card.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers of "
                         f"{sorted(PHASES)} (default: all); the device, the "
                         "build and the data always run")
    args = ap.parse_args(argv)
    if args.phases is None:
        return set(PHASES)
    chosen = {int(x) for x in args.phases.split(",") if x.strip()}
    unknown = chosen - set(PHASES) - {1, 2}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    return chosen & set(PHASES)


def run_kernel_checks(device) -> dict:
    """Phase 3: every kernel against its plain version at the shapes of
    the main paths of phases 4-6."""
    from legommenders_tpu_torch.ops import additive

    checks = []
    shapes = list(POOLS.items()) + [(f"page L{L}", (PAGE_N, L))
                                    for L in PAGE_LS]
    for pool, (N, L) in shapes:
        for dtype in ("f32", "bf16"):
            res = check_pool(pool, N, L, dtype, device)
            checks.append(res)
            log(f"[kernel] {json.dumps(res)}")
    log(f"[kernel] plan (persistent grid, and the tile kernels' tile rows, "
        f"stages, items a tile) by (kernel, L, D, H, bf16, device): "
        f"{additive._grids}")
    edges = check_pool_edges(device)
    log(f"[kernel] pool edges {json.dumps(edges)}")
    attn_checks = []
    for dtype in ("f32", "bf16"):
        res = check_attention(dtype, device)
        attn_checks.append(res)
        log(f"[kernel] packed_attention {json.dumps(res)}")
    train_checks = []
    for dtype in ("f32", "bf16"):
        for p in (TRAIN_DROPOUT, 0.0):
            res = check_attention_train(dtype, p, device)
            train_checks.append(res)
            log(f"[kernel] attention training page {json.dumps(res)}")
    f32 = [c for c in train_checks if c["dtype"] == "f32"]
    log("[kernel] f32 (attention_fwd_tf32 / attention_bwd_tf32, 3xTF32) at "
        "the training page: " + ", ".join(
            f"p {c['dropout']} forward {c['fwd_ms'] * 1e3:.1f} us (bound "
            f"{c['fwd_bound_ms'] * 1e3:.1f} us, {c['fwd_bound_by']}; SDPA "
            f"f32 {c['sdpa_fwd_ms'] * 1e3:.1f} us), backward "
            f"{c['bwd_ms'] * 1e3:.1f} us (bound {c['bwd_bound_ms'] * 1e3:.1f}"
            f" us, {c['bwd_bound_by']}), forward + backward "
            f"{(c['fwd_ms'] + c['bwd_ms']) * 1e3:.1f} us (SDPA f32 "
            f"{c['sdpa_fwd_bwd_ms'] * 1e3:.1f} us)" for c in f32))
    return {"checks": checks, "pool_edges": edges,
            "attn_checks": attn_checks, "train_checks": train_checks}


def run_serving(data, device) -> dict:
    """Phase 4: NAML and bert-naml serving."""
    paths = {}
    for name, cfg, per_page in (("naml", MODEL_CFG, 0),
                                ("bert-naml", BERT_CFG, BERT_LAYERS)):
        paths[name] = run_path(name, cfg, data, device, per_page)
        log(f"[main] {json.dumps(paths[name])}")
    return {"paths": paths}


def run_training(data, device, card="") -> dict:
    """Phase 5: bert-naml layer-split and NAML training."""
    lm_train = run_lm_training(data, device)
    log(f"[main] {json.dumps(lm_train)}")
    log(f"[main] bert-naml remat A/B, same weights and batches: "
        f"{remat_ab_line(lm_train, lm_train['full_remat'])} ({card})")
    naml_train = run_naml_training(data, device)
    log(f"[main] {json.dumps(naml_train)}")
    return {"lm_train": lm_train, "naml_train": naml_train}


def run_loop(data, device, card) -> dict:
    """Phase 6: the run loop."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        loop, m_loop, tr_loop = run_loop_naml(data, device, tmp)
        log(f"[loop] {json.dumps(loop)}")
        full = run_full_forward(m_loop, tr_loop)
        log(f"[loop] {json.dumps(full)}")
        latency = run_latency(m_loop)
        log(f"[loop] {json.dumps(latency)}")
        del m_loop, tr_loop
        torch.cuda.empty_cache()
        dev_loop = run_loop_device_batches(data, device)
        log(f"[loop] {json.dumps(dev_loop)}")
        log(f"[loop] step ms: host batches {loop['step_ms']:.3f}, device "
            f"batches {dev_loop['step_ms']:.3f} ({card})")
        lm_loop = run_loop_lm(data, device)
        log(f"[loop] {json.dumps(lm_loop)}")
        cli = run_cli(tmp)
        log(f"[loop] cli: {cli['outcome']}: {json.dumps(cli)}")
    return {"loop": loop, "full": full, "latency": latency,
            "dev_loop": dev_loop, "lm_loop": lm_loop}


def run_news_zoo(data, device, card) -> dict:
    """Phase 7: the news zoo and the catalog gradient plans."""
    zoo_checks = []
    for pool, (L, h, side) in ZOO_POOLS.items():
        for n, where in ((POOLS[side][0], side), (PAGE_N, "page")):
            for dtype in ("f32", "bf16"):
                res = check_pool(f"{pool} ({where})", n, L, dtype, device,
                                 h=h, plain_iters=2)
                zoo_checks.append(res)
                log(f"[zoo] kernel {json.dumps(res)}")
    zoo = {}
    for name in ZOO_MODELS:
        zoo[name] = run_zoo_model(name, data, device)
        log(f"[zoo] {json.dumps(zoo[name])}")
    plans = run_naml_plans(data, device)
    log(f"[zoo] {json.dumps(plans)}")
    for name, rec in zoo.items():
        log(f"[zoo] {name}: Tester.test() {rec['test_s']:.3f} s "
            f"({rec['eval']}), step {rec['train']['step_ms']:.2f} ms "
            f"({rec['train']['impressions_per_s']:.0f} impressions/s, peak "
            f"{rec['train']['peak_memory_gb']:.2f} GB) ({card})")
    log(f"[zoo] naml step: plans {plans['step_plans']['step_ms']:.2f} ms, "
        f"no plans {plans['step_plain']['step_ms']:.2f} ms ({card})")
    return {"zoo_checks": zoo_checks, "zoo": zoo, "plans": plans}


def run_ctr_zoo(data, device, card) -> dict:
    """Phase 8: the CTR zoo."""
    import tempfile

    ctr_checks = []
    for pool, (n, h) in CTR_POOLS.items():
        for dtype in ("f32", "bf16"):
            res = check_pool(pool, n, 50, dtype, device, h=h)
            ctr_checks.append(res)
            log(f"[ctr] kernel {json.dumps(res)}")
    ctr = {}
    for name in CTR_MODELS:
        ctr[name] = rec = run_ctr_model(name, data, device)
        log(f"[ctr] {json.dumps(rec)}")
        step = rec["train"]
        log(f"[ctr] {name}: Tester.test() {rec['test_s']:.3f} s "
            f"({rec['eval']}, {rec['test_launches']['additive_pool']} pool "
            f"launches), step {step['step_ms']:.2f} ms "
            f"({step['impressions_per_s']:.0f} impressions/s, peak "
            f"{step['peak_memory_gb']:.2f} GB, idle share "
            f"{step['profile']['device_idle_share']}, "
            f"{step['launches_per_step']['additive_pool']:g} pool launches "
            f"a step) ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        ctr_cli = run_cli(tmp, CTR_CLI_MODELS)
    log(f"[ctr] cli: {ctr_cli['outcome']}: {json.dumps(ctr_cli)}")
    return {"ctr_checks": ctr_checks, "ctr": ctr}


def run_decoders(data, device, card) -> dict:
    """Phase 9: the decoder LMs."""
    decoder_checks = {}
    for name in DECODER_PAGES:
        decoder_checks[name] = check_decoder_attention(name, device)
        log(f"[decoder] kernel {json.dumps(decoder_checks[name])}")
    f32_edges = check_f32_backward_edges(device)
    log("[decoder] f32 backward (attention_bwd_tf32) at dh 128: " + ", ".join(
        f"{c['page']} p {c['dropout']} max abs err {c['max_abs_err']:.3g}"
        for c in f32_edges) + f" (gate {F32_TOL:g})")
    c = decoder_checks["llama training"]
    log(f"[decoder] f32 (attention_fwd_tf32 / attention_bwd_tf32) at the "
        f"Llama training page ({c['B']} x {c['T']}, {c['heads']} heads of "
        f"{c['D'] // c['heads']}, p 0): forward {c['f32_ms'] * 1e3:.1f} us "
        f"(bound {c['f32_bound_ms'] * 1e3:.1f} us), backward "
        f"{c['f32_bwd_ms'] * 1e3:.1f} us, bound "
        f"{c['f32_bwd_bound_ms'] * 1e3:.1f} us ({c['f32_bwd_bound_by']}; "
        f"{c['f32_bwd_cuda_core_bound_ms'] * 1e3:.1f} us on the CUDA "
        f"cores), SDPA f32 forward + backward "
        f"{c['f32_library_fwd_bwd_ms'] * 1e3:.1f} us, max abs err "
        f"{max(c[f'f32_{g}_max_abs_err'] for g in ('dq', 'dk', 'dv')):.3g} "
        f"({card})")
    llama_serve = run_llama_serving(data, device)
    log(f"[decoder] {json.dumps(llama_serve)}")
    decoders = {}
    for name, item_config, test, precision in (
            ("llama-naml", dict(num_hidden_layers=LLAMA_TRAIN_LAYERS,
                                tune_from=LLAMA_TUNE_FROM), False, True),
            ("glm-naml", dict(num_hidden_layers=GLM_LAYERS,
                              tune_from=GLM_TUNE_FROM), True, False),
            ("opt-naml", dict(tune_from=OPT_TUNE_FROM), True, False)):
        decoders[name] = rec = run_decoder_training(
            name, decoder_cfg(name, **item_config), data, device, test,
            precision)
        log(f"[decoder] {json.dumps(rec)}")
        step = rec["train"]
        log(f"[decoder] {name} ({rec['layers']} layers, tune_from "
            f"{rec['tune_from']}): cache {rec['cache_s']:.2f} s, "
            f"{'Tester.test() %.3f s, ' % rec['test_s'] if test else ''}"
            f"step {step['step_ms']:.1f} ms ({step['impressions_per_s']:.0f}"
            f" impressions/s, peak {step['peak_memory_gb']:.2f} GB, idle "
            f"share {step.get('profile', {}).get('device_idle_share')}) "
            f"({card})")
    gc = decoders["llama-naml"]["grad_check"]["max_rel_err"]
    log(f"[decoder] llama-naml gradients: K16 vs P16 {gc['K16_vs_P16']:.3g}, "
        f"K32 vs P32 {gc['K32_vs_P32']:.3g} (gate {F32_GRAD_TOL:g}) "
        f"({card})")
    log(f"[decoder] llama-naml serving: Tester.test() "
        f"{llama_serve['test_s']:.2f} s over {data.num_items} items x "
        f"{llama_serve['layers']} layers, peak "
        f"{llama_serve['peak_memory_gb']:.2f} GB, idle share of 8 pages "
        f"{llama_serve['profile']['device_idle_share']} ({card})")
    return {"decoder_checks": decoder_checks, "llama_serve": llama_serve,
            "decoders": decoders, "f32_edges": f32_edges}


def run_phase10(data, device, card) -> dict:
    """Phase 10: the long-sequence pool, IISAN, the BERT zoo, the flatten
    paths and the CLI."""
    import tempfile

    flatten_checks = []
    for pool, (L, h) in FLATTEN_POOLS.items():
        name = pool.split()[0]
        _, batch, eval_batch = FLATTEN_MODELS[name]
        for n, where in ((batch, "step"), (eval_batch, "test page")):
            for dtype in ("f32", "bf16"):
                res = check_pool(f"{pool} ({where})", n, L, dtype, device,
                                 h=h, plain_iters=2)
                flatten_checks.append(res)
                log(f"[flatten] kernel {json.dumps(res)}")
    iisan = {}
    for name in IISAN_MODELS:
        iisan[name] = rec = run_iisan_model(name, data, device)
        log(f"[iisan] {json.dumps(rec)}")
        step = rec["train"]
        log(f"[iisan] {name} ({rec['layers']} layers, selected "
            f"{rec['selected']}): cache {rec['cache_s']:.2f} s "
            f"({rec['cache_launches']['packed_attention']} attention "
            f"launches, the code's "
            f"{rec['expected_cache_launches']['packed_attention']}),"
            f" Tester.test() {rec['test_s']:.3f} s, step "
            f"{step['step_ms']:.2f} ms ({step['impressions_per_s']:.0f} "
            f"impressions/s, peak {rec['peak_memory_gb']:.2f} GB, idle share "
            f"{step['profile']['device_idle_share']}, "
            f"{step['launches_per_step']['additive_pool']:g} pool launches "
            f"a step, the code's "
            f"{rec['expected_launches_per_step']['additive_pool']}) ({card})")
    bert_zoo = {}
    for name in BERT_ZOO_MODELS:
        bert_zoo[name] = rec = run_bert_zoo_model(name, data, device)
        log(f"[bert-zoo] {json.dumps(rec)}")
        step = rec["train"]
        log(f"[bert-zoo] {name} (tune_from {BERT_ZOO_TUNE_FROM}): cache "
            f"{rec['cache_s']:.2f} s, Tester.test() {rec['test_s']:.3f} s "
            f"({rec['eval']}), step {step['step_ms']:.1f} ms "
            f"({step['impressions_per_s']:.0f} impressions/s, peak "
            f"{rec['peak_memory_gb']:.2f} GB), launches a step "
            f"{step['launches_per_step']} = the code's ({card})")
    flatten = {}
    for name in FLATTEN_MODELS:
        flatten[name] = rec = run_flatten_model(name, data, device)
        log(f"[flatten] {json.dumps(rec)}")
        step = rec["train"]
        log(f"[flatten] {name} ({rec['clicks']} clicks, L "
            f"{rec['seq_len']}): Tester.test() {rec['test_s']:.2f} s "
            f"({rec['pages']} full-forward pages of {rec['eval_batch']}, "
            f"peak {rec['test_peak_memory_gb']:.2f} GB, "
            f"{rec['test_launches']['additive_pool']} pool launches, the "
            f"code's {rec['expected_test_launches']['additive_pool']}), step "
            f"{step['step_ms']:.2f} ms at batch {rec['batch']} "
            f"({step['impressions_per_s']:.0f} impressions/s, peak "
            f"{step['peak_memory_gb']:.2f} GB, idle share "
            f"{step['profile']['device_idle_share']}) ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        cli = run_cli(tmp, PHASE10_CLI_MODELS)
    log(f"[iisan] cli: {cli['outcome']}: {json.dumps(cli)}")
    return {"flatten_checks": flatten_checks, "iisan": iisan,
            "bert_zoo": bert_zoo, "flatten": flatten}


# phase 11: the LM knobs, the semantic-ID family, processed MIND
# the `dots` A/B's catalog: at 65,000 items `dots` keeps 9 D a token and
# trainable layer (q, k, v, o, the 4 D intermediate, the FFN output), about
# 72 GB beside the 4 GB cache; 16,384 items (32 pages of 512) keep ~18 GB.
# Users cut to 5,000 with it (the host data build; a step draws 2,048).
DOTS_DATA_KW = dict(DATA_KW, num_items=16384, num_users=5000)
# one page of each decoder knob check: 512 items, as the cache pages
KNOB_PAGE = 512
# norm_bf16's bf16 gradients lie at most 2.31 times as far from f32 as the
# knob-off bf16 path's, tensor by tensor (H100, seed 0, 16,384 items):
# the bound its gate holds them to
NORM_BF16_GRAD_RATIO = 3.0
LLAMA_NORM_LAYERS = 2
SEMANTIC_STEPS = 4
# TIGER's semantic IDs (Rajput et al., NeurIPS 2023): three RQ-VAE levels of
# 256 codes plus one collision code, 4 codes an item; a user has 4 too
SEMANTIC_CODES, SEMANTIC_BOOK = 4, 256
SEMANTIC_BASE = {"use_item_content": True, "hidden_size": 64,
                 "cache_page_size": 512}
SEMANTIC_MODELS = {
    "ada-semantic-poly": {
        "meta": {"item": "Ada", "user": "Semantic", "predictor": "Poly"},
        "config": {**SEMANTIC_BASE,
                   "user_config": {"base_operator": "Ada",
                                   "return_stack": True},
                   "predictor_config": {"base_predictor": "Dot",
                                        "num_layers": SEMANTIC_CODES}}},
    "ada-semantic-dot": {
        "meta": {"item": "Ada", "user": "Semantic", "predictor": "Dot"},
        "config": {**SEMANTIC_BASE,
                   "user_config": {"base_operator": "Ada"}}},
    "scsimple-scmix-semanticmix": {
        "meta": {"item": "SCSimple", "user": "SCMix",
                 "predictor": "SemanticMix"},
        "config": {**SEMANTIC_BASE,
                   "predictor_config": {"base_predictor": "Dot"}}},
}
# the semantic item pool: Ada over an item's 4 codes, the whole catalog,
# at Ada's default H
SEMANTIC_POOLS = {"semantic items": (65000, SEMANTIC_CODES, H)}
# the processed-MIND CLI run: a fake MIND raw layout at `make smoke`'s
# geometry (400 news, 200 users), GloVe words of width 50
MIND_RAW = dict(news=400, users=200, behaviors=600, history=10,
                impressions=8, glove_dim=50)


def _bert_knob_model(data, device, policy="full"):
    """bert-naml layer-split (BERT_TRAIN_CFG under `policy`) with its
    cache built."""
    import copy

    from legommenders_tpu_torch.runtime.manager import Manager

    cfg = copy.deepcopy(BERT_TRAIN_CFG)
    cfg["config"]["item_page_remat"] = policy
    m = Manager(model_cfg=cfg, exp_cfg=EXP_CFG, data=data, device=device,
                seed=0)
    assert m.prepare_lm_cache(root=None)
    return m


def _set_knob(model, knob: str, on: bool):
    """Turn fused_qkv or norm_bf16 on or off in every module that has it;
    returns how many modules it set."""
    from legommenders_tpu_torch.models.common import FrozenableLayerNorm
    from legommenders_tpu_torch.models.lm.layers import RMSNorm

    n = 0
    for mod in model.modules():
        if knob == "fused_qkv" and hasattr(mod, "fused_qkv"):
            mod.fused_qkv = on
            n += 1
        elif knob == "norm_bf16" and isinstance(
                mod, (FrozenableLayerNorm, RMSNorm)):
            mod.bf16_apply = on
            n += 1
    return n


def run_knob_steps(m, data, device, expected: dict) -> dict:
    """11.1: the same model and batches under `full`, `dots`, and `full`
    with fused_qkv, then with norm_bf16: AB_STEPS timed steps and one
    profiled each, the weights restored before each. Raises unless every
    run's launches a step are the code's and its losses lie within
    BF16_REL_TOL of `full`'s (`shared_loss_err`)."""
    start = _snapshot(m.model)
    runs = {}
    for label, policy, knob in (("full", "full", None),
                                ("dots", "dots", None),
                                ("fused_qkv", "full", "fused_qkv"),
                                ("norm_bf16", "full", "norm_bf16")):
        m.model.load_state_dict(start)
        m.model.item_page_remat = policy
        if knob:
            _set_knob(m.model, knob, True)
        runs[label], _ = _train_steps(m, data, device, AB_STEPS)
        if knob:
            _set_knob(m.model, knob, False)
        runs[label]["launches_equal_code"] = (
            runs[label]["launches_per_step"] == expected)
        if label != "full":
            runs[label]["loss_rel_err_vs_full"] = shared_loss_err(
                runs[label], runs["full"])
    m.model.load_state_dict(start)
    m.model.item_page_remat = "full"
    problems = [f"{k} launches" for k, r in runs.items()
                if not r["launches_equal_code"]]
    problems += [f"{k} losses" for k, r in runs.items()
                 if r.get("loss_rel_err_vs_full", 0.0) > BF16_REL_TOL]
    if problems:
        raise RuntimeError(f"knob steps failed ({problems}): {runs}")
    return runs


def knob_grad_check(m16, data, device) -> dict:
    """11.1: the gradient of every trainable tensor on one batch at dropout
    0 with fused_qkv, with norm_bf16 and under the `dots` remat, against
    the same weights with the knob off under `full`: fused_qkv at f32
    (F32_GRAD_TOL of each tensor's largest; a cuBLAS product of width 3 D
    sums in another order than three of D) and at bf16, and `dots` at
    bf16, each by precision_check's rule against the knob-off bf16
    gradients. norm_bf16 rounds each norm's output to bf16 before its
    scale and shift: the item vectors of the first page (eval) within 2e-2
    of the largest of the knob-off ones, the loss within 2e-2, and each
    tensor's bf16 gradient against the knob-off f32 one within
    NORM_BF16_GRAD_RATIO times the knob-off bf16 path's own error (bf16
    gradients lie up to 0.45 of their largest from f32 ones:
    precision_check), or 2e-2 where that is larger."""
    import copy

    import torch
    from legommenders_tpu_torch.data.device_pipeline import (
        DeviceTrainPipeline, step_generator,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    dp = DeviceTrainPipeline(data, batch_size=TRAIN_BATCH, neg_count=4,
                             seed=0, device=device)
    idx = next(dp.epoch_indices(shuffle=False))
    batch = dp.assemble(idx, step_generator(0, 10 ** 6, device))
    g = torch.Generator(device=device).manual_seed(5)
    with torch.no_grad():
        for mod in m16.model.modules():
            if getattr(mod, "lora_r", 0) > 0:
                mod.lora_B.normal_(0.0, 0.05, generator=g)
    rec = {"loss": {}}
    page = {c: a[:KNOB_PAGE] for c, a in m16.contents.columns.items()}
    vecs = {}
    with torch.inference_mode():
        for on in (False, True):
            _set_knob(m16.model, "norm_bf16", on)
            vecs[on] = m16.model.encode_item_content(page).float()
    _set_knob(m16.model, "norm_bf16", False)
    rec["norm_bf16_item_rel_err"] = float(
        (vecs[True] - vecs[False]).abs().max() / vecs[False].abs().max())
    grads = {}
    for name, knob in (("U16", None), ("F16", "fused_qkv"),
                       ("N16", "norm_bf16")):
        if knob:
            _set_knob(m16.model, knob, True)
        rec["loss"][name], grads[name] = _grads(m16, batch, False)
        if knob:
            _set_knob(m16.model, knob, False)
    policy = m16.model.item_page_remat
    m16.model.item_page_remat = "dots"
    rec["loss"]["D16"], grads["D16"] = _grads(m16, batch, False)
    m16.model.item_page_remat = policy
    cfg = copy.deepcopy(BERT_TRAIN_CFG)
    cfg["config"]["item_page_remat"] = "full"
    cfg["config"]["item_config"]["lm_dtype"] = "f32"
    m32 = Manager(model_cfg=cfg, exp_cfg={"policy": {"dtype": "f32"}},
                  data=data, device=device, seed=0)
    m32.model.load_state_dict(m16.model.state_dict())
    assert m32.prepare_lm_cache(root=None)
    for name, knob in (("U32", None), ("F32", "fused_qkv")):
        if knob:
            _set_knob(m32.model, knob, True)
        rec["loss"][name], grads[name] = _grads(m32, batch, False)
    del m32
    torch.cuda.empty_cache()
    err = {k: _rel_errs(grads[a], grads[b]) for k, (a, b) in {
        "F32_vs_U32": ("F32", "U32"), "F16_vs_U16": ("F16", "U16"),
        "U16_vs_U32": ("U16", "U32"), "N16_vs_U32": ("N16", "U32"),
        "N16_vs_U16": ("N16", "U16"), "D16_vs_U16": ("D16", "U16")}.items()}
    rec["max_rel_err"] = {k: max(v.values()) for k, v in err.items()}
    # precision_check's bf16 rule: within 2e-2 of each tensor's largest, or
    # half the bf16 path's own error against f32 where that is larger
    fused_limit = {n: max(BF16_REL_TOL, 0.5 * e)
                   for n, e in err["U16_vs_U32"].items()}
    rec["tensors"] = len(grads["U32"])
    problems = [f"fused f32 {n}" for n, e in err["F32_vs_U32"].items()
                if e > F32_GRAD_TOL]
    problems += [f"fused bf16 {n}" for n, e in err["F16_vs_U16"].items()
                 if e > fused_limit[n]]
    problems += [f"dots {n}" for n, e in err["D16_vs_U16"].items()
                 if e > fused_limit[n]]
    # norm_bf16 adds a rounding to bf16 before each norm's scale and shift:
    # each tensor's error against f32 within NORM_BF16_GRAD_RATIO times the
    # knob-off bf16 path's own, or BF16_REL_TOL where that is larger
    norm_limit = {n: max(BF16_REL_TOL, NORM_BF16_GRAD_RATIO * e)
                  for n, e in err["U16_vs_U32"].items()}
    problems += [f"norm_bf16 {n}" for n, e in err["N16_vs_U32"].items()
                 if not e <= norm_limit[n]]
    loss_err = abs(rec["loss"]["N16"] - rec["loss"]["U16"]) / abs(
        rec["loss"]["U16"])
    rec["norm_bf16_loss_rel_err"] = loss_err
    if loss_err > BF16_REL_TOL:
        problems.append("norm_bf16 loss")
    if rec["norm_bf16_item_rel_err"] > BF16_REL_TOL:
        problems.append("norm_bf16 item vectors")
    # the norm_bf16 gradients' error against f32 over the knob-off bf16
    # path's, per tensor
    rec["norm_bf16_grad_ratio"] = max(
        e / max(err["U16_vs_U32"][n], 1e-30)
        for n, e in err["N16_vs_U32"].items())
    rec["max_over_limit"] = {
        "fused_bf16": max(e / fused_limit[n]
                          for n, e in err["F16_vs_U16"].items()),
        "dots_bf16": max(e / fused_limit[n]
                         for n, e in err["D16_vs_U16"].items()),
        "norm_bf16": max(e / norm_limit[n]
                         for n, e in err["N16_vs_U32"].items())}
    if problems:
        raise RuntimeError(f"knob gradients disagree ({problems}): {rec}")
    return rec


def decoder_page_knob(name: str, cfg: dict, knob: str, data, device) -> dict:
    """11.1: one page of KNOB_PAGE items through a decoder in full-LM mode
    (`cfg`), bf16, with `knob` off and on: the item vectors within 2e-2 of
    the largest, each side timed and profiled once (its matrix-product
    launches: fused_qkv makes one of a layer's three)."""
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager

    rec = {"path": f"{name} page, {knob}"}
    m = Manager(model_cfg=cfg, exp_cfg=DECODER_EXP, data=data,
                device=device, seed=0)
    op = m.model.item_op
    rec.update(layers=op.num_hidden_layers, operator=type(op).__name__)
    page = {c: a[:KNOB_PAGE] for c, a in m.contents.columns.items()}
    out = {}
    with torch.inference_mode():
        for on in (False, True):
            rec["modules_set"] = _set_knob(m.model, knob, on)
            _zero_counts()
            out[on] = m.model.encode_item_content(page).float()
            rec[f"launches_{'on' if on else 'off'}"] = _counts()
            side = "on" if on else "off"
            rec[f"ms_{side}"] = time_ms(
                lambda: m.model.encode_item_content(page), iters=5,
                warmup=1)
            pr = profile_window(lambda: m.model.encode_item_content(page))
            rec[f"gemm_launches_{side}"] = pr["gemm_launches"]
            rec[f"gemm_ms_{side}"] = pr["gemm_ms"]
    rec["rel_err"] = float((out[True] - out[False]).abs().max()
                           / out[False].abs().max())
    rec["finite"] = bool(torch.isfinite(out[True]).all())
    rec["expected_launches"] = op.num_hidden_layers
    del m, op, page, out
    torch.cuda.empty_cache()
    if not rec["finite"] or rec["rel_err"] > BF16_REL_TOL or any(
            rec[f"launches_{s}"]["packed_attention"]
            != rec["expected_launches"] for s in ("on", "off")):
        raise RuntimeError(f"{name} {knob} page failed: {rec}")
    return rec


def semantic_data(data):
    """The fixture with a semantic-code column of SEMANTIC_CODES codes an
    item and a user-code column of as many codes a user, each from a
    codebook of SEMANTIC_BOOK entries drawn from seeds 0 and 1, as the
    data's only item and user inputs (a copy of `data`; the stores gain
    the columns)."""
    import copy

    import numpy as np
    from legommenders_tpu_torch.data.vocab import Vocab

    out = copy.copy(data)
    for store, n, seed in ((data.items, data.num_items, 0),
                           (data.users, data.num_users, 1)):
        if "semantic" not in store:
            codes = np.random.default_rng(seed).integers(
                0, SEMANTIC_BOOK, size=(n, SEMANTIC_CODES), dtype=np.int32)
            store.add_seq_column("semantic", codes.tolist(), Vocab(
                "semantic", tokens=None).set_size(SEMANTIC_BOOK),
                SEMANTIC_CODES)
    out.item_inputs = [("semantic", SEMANTIC_CODES)]
    out.user_inputs = [("semantic", SEMANTIC_CODES)]
    return out


def run_semantic_model(name: str, data, device) -> dict:
    """11.2: one semantic composition at the fixture's geometry, bf16:
    Tester.test() by full forwards over the test rows (the user operators
    refuse caching), SEMANTIC_STEPS fused training steps of 2,048; the
    pool's launches per page and per step against the modules' count."""
    import numpy as np
    import torch
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester

    rec = {"path": name}
    t0 = time.perf_counter()
    m = Manager(model_cfg=SEMANTIC_MODELS[name], exp_cfg=ZOO_EXP, data=data,
                device=device, seed=0)
    tester = Tester(m)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    model = m.model
    rec["operators"] = [type(x).__name__ for x in (
        model.item_op, model.user_op, model.predictor)]
    pools = _pools_of(model.item_op) + _pools_of(model.user_op)
    rec["pools_per_forward"] = pools
    _zero_counts()
    t0 = time.perf_counter()
    rec["metrics"] = tester.test()
    torch.cuda.synchronize()
    rec["test_s"] = time.perf_counter() - t0
    rec["test_launches"] = _counts()
    ev = tester.evaluator
    rec["rows"] = ev.phase("test").n
    rec["pages"] = -(-rec["rows"] // ev.batch_size)
    rec["eval"] = "full forward" if m.cache is None else "cached"
    rec["expected_test_launches"] = {
        "additive_pool": rec["pages"] * pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    rec["train"], dp = _train_steps(m, data, device, SEMANTIC_STEPS)
    rec["expected_launches_per_step"] = {
        "additive_pool": pools, "packed_attention": 0,
        "packed_attention_backward": 0, "dropout_keep_mask": 0}
    problems = []
    if m.cache is not None:
        problems.append("a flatten user operator was cached")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0
               for v in rec["metrics"].values()):
        problems.append("metrics not finite in [0, 1]")
    if rec["test_launches"] != rec["expected_test_launches"]:
        problems.append("test launches")
    if rec["train"]["launches_per_step"] != rec["expected_launches_per_step"]:
        problems.append("training launches")
    del m, tester, ev, model, dp
    torch.cuda.empty_cache()
    if problems:
        raise RuntimeError(f"{name} failed ({problems}): {rec}")
    return rec


def write_fake_mind(root: str, seed: int = 0) -> dict:
    """A fake MIND raw layout under `root` (train/ and dev/, each with
    news.tsv and behaviors.tsv, MIND_RAW's geometry) and a GloVe text file
    over its words; returns their paths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = MIND_RAW
    words = [f"w{i}" for i in range(300)]
    cats = ["news", "sports", "finance", "lifestyle", "health"]
    nids = [f"N{i}" for i in range(g["news"])]
    for split in ("train", "dev"):
        d = os.path.join(root, split)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "news.tsv"), "w") as f:
            for i, nid in enumerate(nids):
                title = " ".join(rng.choice(words, int(rng.integers(5, 20))))
                abstract = " ".join(rng.choice(words, 30))
                f.write(f"{nid}\t{cats[i % 5]}\tsub{i % 17}\t{title}\t"
                        f"{abstract}\t\t\t\n")
        with open(os.path.join(d, "behaviors.tsv"), "w") as f:
            for b in range(g["behaviors"]):
                hist = " ".join(rng.choice(nids, g["history"],
                                           replace=False))
                imps = " ".join(f"{n}-{int(rng.random() < 0.2)}" for n in
                                rng.choice(nids, g["impressions"],
                                           replace=False))
                f.write(f"{b + 1}\tU{b % g['users']}\t11/11/2019 9:05:58 AM"
                        f"\t{hist}\t{imps}\n")
    glove = os.path.join(root, "glove.txt")
    with open(glove, "w") as f:
        for w in words:
            vec = rng.standard_normal(g["glove_dim"]).round(5)
            f.write(w + " " + " ".join(str(x) for x in vec) + "\n")
    return {"raw": root, "glove": glove}


def run_processed_mind(tmp, device) -> dict:
    """11.3: `process --data mind --tokenizers glove:<file>` over a fake
    MIND raw layout, then NAML trained and tested through the port's CLI
    on the processed stores (`make smoke`'s steps: 2 epochs of 4 batches
    of 16, hidden 16); the pool's launches over the run."""
    from legommenders_tpu_torch import process, trainer

    rec = {"path": "processed MIND through the CLI"}
    paths = write_fake_mind(os.path.join(tmp, "mind_raw"))
    save = os.path.join(tmp, "data", "mind")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        stores = process.main(["--data", "mind", "--raw_dir", paths["raw"],
                               "--save_dir", save, "--tokenizers",
                               f"glove:{paths['glove']}"])
        rec["process_s"] = time.perf_counter() - t0
        rec["stores"] = {k: [len(v), sorted(v.col_names())]
                         for k, v in stores.items()}
        _zero_counts()
        t0 = time.perf_counter()
        argv = ["--data", "mind", "--model", "naml", "--epoch", "2",
                "--epoch_batch", "4", "--batch_size", "16",
                "--hidden_size", "16", "--data_dir", save]
        if str(device) == "cpu":
            argv += ["--device", "cpu"]
        rec["results"] = trainer.main(argv)
        rec["train_test_s"] = time.perf_counter() - t0
        rec["launches"] = _counts()
    finally:
        os.chdir(cwd)
    if "title@glove" not in stores["items"] or not rec["launches"][
            "additive_pool"] or not all(
            math.isfinite(v) for v in rec["results"].values()):
        raise RuntimeError(f"processed MIND failed: {rec}")
    rec["outcome"] = "ran"
    return rec


def run_phase11(data, device, card) -> dict:
    """Phase 11: the LM knobs (the `dots` remat, fused_qkv, norm_bf16), the
    semantic-ID family, processed MIND through the CLI."""
    import tempfile

    import torch
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )

    # 11.1 the LM knobs
    t0 = time.perf_counter()
    data16 = SyntheticProcessor(**DOTS_DATA_KW).as_lego_data()
    knobs = {"data_s": time.perf_counter() - t0,
             "catalog": data16.num_items}
    m = _bert_knob_model(data16, device)
    op = m.model.item_op
    n_pages = -(-data16.num_items // m.model.item_page_size)
    upper = op.num_hidden_layers - op.resolved_tune_from
    expected = {"packed_attention": 2 * upper * n_pages,
                "packed_attention_backward": upper * n_pages,
                "additive_pool": 2 * n_pages + 1, "dropout_keep_mask": 0}
    knobs["expected_launches_per_step"] = expected
    knobs["steps"] = steps = run_knob_steps(m, data16, device, expected)
    knobs["grads"] = knob_grad_check(m, data16, device)
    del m, op
    torch.cuda.empty_cache()
    for label, r in steps.items():
        pr = r["profile"]
        log(f"[knobs] bert-naml {label} ({data16.num_items} items, "
            f"{n_pages} pages): step {r['step_ms']:.1f} ms, peak "
            f"{r['peak_memory_gb']:.2f} GB, idle share "
            f"{pr['device_idle_share']}, GEMM launches {pr['gemm_launches']}"
            f" ({pr['gemm_ms']:.1f} ms), launches a step "
            f"{r['launches_per_step']} = the code's: "
            f"{r['launches_equal_code']} ({card})")
    log(f"[knobs] dots vs full: "
        f"{remat_ab_line(steps['dots'], steps['full'], ('dots', 'full'))}")
    gr = knobs["grads"]
    log(f"[knobs] gradients: fused_qkv f32 "
        f"{gr['max_rel_err']['F32_vs_U32']:.3g} (gate {F32_GRAD_TOL:g}), "
        f"bf16 {gr['max_rel_err']['F16_vs_U16']:.3g} "
        f"({gr['max_over_limit']['fused_bf16']:.3g} of its limit); "
        f"dots bf16 {gr['max_rel_err']['D16_vs_U16']:.3g} "
        f"({gr['max_over_limit']['dots_bf16']:.3g} of its limit); "
        f"norm_bf16: item vectors {gr['norm_bf16_item_rel_err']:.3g}, loss "
        f"{gr['norm_bf16_loss_rel_err']:.3g} (gate {BF16_REL_TOL:g}), "
        f"gradients against f32 {gr['max_rel_err']['N16_vs_U32']:.3g} "
        f"(knob off {gr['max_rel_err']['U16_vs_U32']:.3g}; at most "
        f"{gr['norm_bf16_grad_ratio']:.3g}x a tensor's knob-off error, "
        f"gate {NORM_BF16_GRAD_RATIO:g}x: "
        f"{gr['max_over_limit']['norm_bf16']:.3g} of its limit), against "
        f"the knob off at bf16 {gr['max_rel_err']['N16_vs_U16']:.3g} "
        f"({card})")
    knobs["glm_fused_qkv"] = decoder_page_knob(
        "glm-naml", decoder_cfg("glm-naml", num_hidden_layers=GLM_LAYERS,
                                tune_from=None),
        "fused_qkv", data, device)
    knobs["llama_norm_bf16"] = decoder_page_knob(
        "llama-naml", decoder_cfg("llama-naml",
                                  num_hidden_layers=LLAMA_NORM_LAYERS,
                                  tune_from=None),
        "norm_bf16", data, device)
    for key in ("glm_fused_qkv", "llama_norm_bf16"):
        r = knobs[key]
        log(f"[knobs] {r['path']} ({r['layers']} layers, {KNOB_PAGE} "
            f"items): off {r['ms_off']:.2f} ms, on {r['ms_on']:.2f} ms, "
            f"GEMM launches {r['gemm_launches_off']} / "
            f"{r['gemm_launches_on']}, rel err {r['rel_err']:.3g} (gate "
            f"{BF16_REL_TOL:g}), "
            f"attention launches {r['launches_on']['packed_attention']} = "
            f"the code's {r['expected_launches']} ({card})")
    log(f"[knobs] {json.dumps(knobs)}")
    del data16

    # 11.2 the semantic-ID family
    sdata = semantic_data(data)
    semantic_checks = []
    for pool, (n, L, h) in SEMANTIC_POOLS.items():
        for dtype in ("f32", "bf16"):
            res = check_pool(pool, n, L, dtype, device, h=h)
            semantic_checks.append(res)
            log(f"[semantic] kernel {json.dumps(res)}")
    semantic = {}
    for name in SEMANTIC_MODELS:
        semantic[name] = rec = run_semantic_model(name, sdata, device)
        log(f"[semantic] {json.dumps(rec)}")
        st = rec["train"]
        log(f"[semantic] {name} ({' / '.join(rec['operators'])}): "
            f"Tester.test() {rec['test_s']:.2f} s by {rec['pages']} full "
            f"forwards ({rec['test_launches']['additive_pool']} pool "
            f"launches, the code's "
            f"{rec['expected_test_launches']['additive_pool']}: "
            f"{rec['pools_per_forward']} a page), step {st['step_ms']:.2f} "
            f"ms ({st['impressions_per_s']:.0f} impressions/s, peak "
            f"{st['peak_memory_gb']:.2f} GB, idle share "
            f"{st['profile']['device_idle_share']}, "
            f"{st['launches_per_step']['additive_pool']:g} pool launches a "
            f"step, the code's "
            f"{rec['expected_launches_per_step']['additive_pool']}) "
            f"({card})")

    # 11.3 processed MIND through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        mind = run_processed_mind(tmp, device)
    log(f"[semantic] processed MIND: {mind['outcome']}: {json.dumps(mind)}")
    return {"knobs": knobs, "semantic_checks": semantic_checks,
            "semantic": semantic, "processed_mind": mind}


# phase 12: the offline drivers, the embedders, the lego-server and the dp
# axis. The splitter's cache: bert-naml's layers 0-9 (`--layers -2` wraps
# to 10 of 12, bench_lm.py's tune_from) over the 16,384-item catalog of
# phase 11 (32 pages of 512); NAML's dp run takes host batches of 16,384.
SPLIT_LAYERS = "-2"
# the two bert-naml Trainers' repr caches after their step and dev pass,
# over the largest value (both steps under `deterministic`: bit-equal is
# expected and printed; the gate leaves room for a kernel's own order)
SPLIT_REPR_TOL = 1e-3
DP_BATCH, DP_STEPS = 16384, 5
# BERT-base's word-piece vocabulary: the table the embed check exports
BERT_VOCAB = 30522
# the worker's job: make smoke's geometry through the CLI, 2 seeds
WORKER_JOB = ("--data synthetic --data_dir {data_dir} --model naml --epoch 1 "
              "--epoch_batch 2 --batch_size 16 --hidden_size 16")
WORKER_SEEDS = 2
WORKER_TIMEOUT_S = 120
PHASE12_POLICY = {"dtype": "bf16", "batch_size": TRAIN_BATCH,
                  "lr": TRAIN_LR, "epoch": 1}


def _bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def run_extractor_check(data, device, tmp) -> dict:
    """12.1: NAML's Trainer (2 steps of 2,048, a dev pass) writes its best
    checkpoint; the extractor loads it into a Manager of another seed and
    exports the repr caches, which must equal Tester's cache on the
    trained weights bit for bit, from one pool launch a cache page."""
    import numpy as np
    import torch
    from legommenders_tpu_torch import extractor
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester
    from legommenders_tpu_torch.runtime.trainer import Trainer

    exp = {"policy": {**PHASE12_POLICY, "epoch_batch": 2}}
    ckpt = os.path.join(tmp, "naml.ckpt")
    m = Manager(model_cfg=MODEL_CFG, exp_cfg=exp, data=data, device=device,
                seed=0)
    Trainer(m, seed=0, ckpt_path=ckpt, lm_cache_root=None).train()
    Tester(m).test()
    want = (m.cache.item_repr.float().cpu(), m.cache.user_repr.float().cpu())
    m2 = Manager(model_cfg=MODEL_CFG, exp_cfg=exp, data=data, device=device,
                 seed=1)
    _zero_counts()
    t0 = time.perf_counter()
    paths = extractor.extract(m2, os.path.join(tmp, "export"), "phase12",
                              load_path=ckpt)
    torch.cuda.synchronize()
    rec = {"path": "extractor (NAML)", "s": time.perf_counter() - t0,
           "launches": _counts(), "expected_pool_launches": _eval_pages(m2)}
    got = [torch.from_numpy(np.load(p)) for p in paths]
    rec["shapes"] = [list(g.shape) for g in got]
    rec["bit_equal"] = [_bit_equal(g, w) for g, w in zip(got, want)]
    problems = []
    if not all(rec["bit_equal"]):
        problems.append("the exported reprs are not Tester's")
    if got[0].shape != (data.num_items, D):
        problems.append("item reprs' shape")
    if (rec["launches"]["additive_pool"] != rec["expected_pool_launches"]
            or rec["launches"]["packed_attention"]):
        problems.append("kernel launches")
    if problems:
        raise RuntimeError(f"extractor failed ({problems}): {rec}")
    del m, m2
    torch.cuda.empty_cache()
    return rec


def run_splitter_check(data16, device, tmp) -> dict:
    """12.2 and 12.3: the splitter writes bert-naml's lower-slice cache at
    `--layers -2` (10) over `data16`; a Trainer reading it (no lower-slice
    attention launch in its init) and one building its cache in memory
    each take a step (`deterministic`) and a dev pass from the same
    weights: the caches and the losses must be equal bit for bit, the
    repr caches within SPLIT_REPR_TOL. Then the sizer's count at full
    width."""
    import copy

    import torch
    from legommenders_tpu_torch import sizer, splitter
    from legommenders_tpu_torch.models.operators.lm_ops import LM_HIDDEN_KEY
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.trainer import Trainer

    cfg = copy.deepcopy(BERT_TRAIN_CFG)
    cfg["config"]["use_fast_eval"] = True
    exp = {"policy": {**PHASE12_POLICY, "epoch_batch": 1}}
    root = os.path.join(tmp, "cache")

    def make_manager(layer):
        return Manager(model_cfg=splitter.with_tune_from(cfg, layer),
                       exp_cfg=exp, data=data16, device=device, seed=0)

    layers = splitter.resolve_layers(SPLIT_LAYERS, BERT_LAYERS)
    n_pages = -(-data16.num_items // cfg["config"]["cache_page_size"])
    rec = {"path": "splitter (bert-naml)", "layers": layers,
           "catalog": data16.num_items}
    _zero_counts()
    t0 = time.perf_counter()
    files = splitter.split(make_manager, layers, root=root, log=log)
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - t0
    rec["launches"] = _counts()
    rec["expected_attention_launches"] = layers[0] * n_pages
    d = os.path.dirname(files[layers[0]][0])
    rec["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d))
    trainers = {}
    for side, cache_root in (("disk", root), ("memory", None)):
        m = make_manager(layers[0])
        tr = Trainer(m, seed=0, lm_cache_root=cache_root)
        _zero_counts()
        t0 = time.perf_counter()
        tr.init()
        torch.cuda.synchronize()
        init = {"s": time.perf_counter() - t0, "launches": _counts()}
        _zero_counts()
        with deterministic():
            tr.train()
        trainers[side] = (m, tr)
        rec[side] = {"init": init, "train_launches": _counts(),
                     "losses": tr.losses, "dev": tr.epochs[0]["dev"]}
    (md, td), (mm, tm) = trainers["disk"], trainers["memory"]
    rec["cache_bit_equal"] = _bit_equal(md.contents.columns[LM_HIDDEN_KEY],
                                        mm.contents.columns[LM_HIDDEN_KEY])
    rec["losses_equal"] = td.losses == tm.losses and len(td.losses) == 1
    reprs = ((md.cache.item_repr, mm.cache.item_repr),
             (md.cache.user_repr, mm.cache.user_repr))
    rec["reprs_bit_equal"] = [_bit_equal(a, b) for a, b in reprs]
    rec["reprs_rel_err"] = [float((a.float() - b.float()).abs().max())
                            / max(float(b.float().abs().max()), 1e-30)
                            for a, b in reprs]
    rows, total = sizer.count(md.model)
    rec["sizer"] = {"parameters": len(rows), "total": total,
                    "trainable": sum(p.numel() for p in md.model.parameters()
                                     if p.requires_grad)}
    problems = []
    if rec["launches"]["packed_attention"] != rec[
            "expected_attention_launches"]:
        problems.append("the splitter's attention launches")
    if rec["disk"]["init"]["launches"]["packed_attention"]:
        problems.append("the Trainer rebuilt the splitter's cache")
    if rec["memory"]["init"]["launches"]["packed_attention"] != rec[
            "expected_attention_launches"]:
        problems.append("the in-memory cache's attention launches")
    if not (rec["cache_bit_equal"] and rec["losses_equal"]
            and max(rec["reprs_rel_err"]) <= SPLIT_REPR_TOL):
        problems.append("the Trainers differ")
    if total != sum(p.numel() for p in md.model.parameters()):
        problems.append("the sizer's total")
    if rec["bytes"] > 4e9:
        problems.append("the cache's disk bytes")
    if problems:
        raise RuntimeError(f"splitter failed ({problems}): {rec}")
    del trainers, md, mm, td, tm
    torch.cuda.empty_cache()
    return rec


def run_embed_check(data, device, tmp) -> dict:
    """12.4: an HF-layout BERT checkpoint (`pytorch_model.bin` holding a
    random 30,522 x 768 word-embedding table under BERT's names) through
    `embed --model bertbase`; the exported table must equal it, and a NAML
    Manager given the exported config (vocab_name set to the fixture's
    `word`) holds it frozen and serves through Tester.test()."""
    import numpy as np
    import torch
    from legommenders_tpu_torch import embed
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.tester import Tester
    from legommenders_tpu_torch.utils.io import yaml_load

    ckpt = os.path.join(tmp, "bert-base")
    os.makedirs(ckpt)
    g = torch.Generator().manual_seed(0)
    table = torch.randn((BERT_VOCAB, 768), generator=g) * 0.02
    torch.save({"bert.embeddings.word_embeddings.weight": table,
                "bert.embeddings.position_embeddings.weight":
                    torch.zeros(512, 768)},
               os.path.join(ckpt, "pytorch_model.bin"))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        path, cfg_path = embed.main(["--model", "bertbase", "--model_path",
                                     ckpt])
        rec = {"path": "embed (bertbase)", "s": time.perf_counter() - t0}
        exported = np.load(path)
        embed_cfg = yaml_load(cfg_path)
        embed_cfg["embeddings"][0]["vocab_name"] = "word"
        embed_cfg["embeddings"][0]["path"] = os.path.abspath(path)
    finally:
        os.chdir(cwd)
    rec["bit_equal"] = exported.tobytes() == table.numpy().tobytes()
    m = Manager(model_cfg=MODEL_CFG, embed_cfg=embed_cfg, exp_cfg=EXP_CFG,
                data=data, device=device, seed=0)
    held = m.model.eh.tables["vocab__word"]
    rec["frozen"] = not held.requires_grad
    rec["loaded_equal"] = _bit_equal(held.detach().cpu(), table)
    _zero_counts()
    res = Tester(m).test()
    rec["test"] = res
    rec["launches"] = _counts()
    if not (rec["bit_equal"] and rec["frozen"] and rec["loaded_equal"]
            and all(math.isfinite(v) for v in res.values())
            and rec["launches"]["additive_pool"] == _eval_pages(m)):
        raise RuntimeError(f"embed failed: {rec}")
    del m
    torch.cuda.empty_cache()
    return rec


def _stub_server():
    """A lego-server stub on a local thread (the wire contract of
    utils/server.py); returns (uri, state, shutdown)."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer
    from urllib.parse import parse_qs, urlparse

    state = {"evaluations": {}, "experiments": {}, "next": 100}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body, identifier="OK"):
            payload = json.dumps({"identifier": identifier,
                                  "body": body}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _data(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n)) if n else {}

        def do_POST(self):
            path, data = urlparse(self.path).path, self._data()
            evals, exps = state["evaluations"], state["experiments"]
            if path == "/evaluations/":
                evals.setdefault(data["signature"], {
                    "signature": data["signature"],
                    "command": data["command"], "experiments": []})
                return self._send(evals[data["signature"]])
            if path == "/experiments/":
                ev = evals[data["signature"]]
                for e in ev["experiments"]:
                    if e["seed"] == data["seed"]:
                        return self._send(e["session"])
                session = str(state["next"])
                state["next"] += 1
                exps[session] = {"signature": data["signature"],
                                 "seed": data["seed"], "session": session,
                                 "is_completed": False, "pid": None}
                ev["experiments"].append(exps[session])
                return self._send(session)
            if path.endswith("/register"):
                exps[path.split("/")[2]]["pid"] = data["pid"]
                return self._send(None)
            return self._send(None, "NOT_FOUND")

        def do_GET(self):
            parsed = urlparse(self.path)
            query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            if parsed.path == "/evaluations/":
                return self._send({"total_page": 1, "evaluations": list(
                    state["evaluations"].values())})
            exp = state["experiments"].get(query.get("session"))
            return self._send(exp, "OK" if exp else "NOT_FOUND")

        def do_PUT(self):
            data = self._data()
            state["experiments"][data["session"]].update(
                is_completed=True, log=data["log"],
                performance=data["performance"])
            return self._send(None)

    httpd = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        thread.join()

    return f"http://127.0.0.1:{httpd.server_port}", state, stop


def run_worker_check(tmp) -> dict:
    """12.5: the worker runs one NAML job over 2 seeds (each a trainer
    process on the card, under a timeout) against the stub server: each
    seed is registered and completed with its metrics as JSON; a second
    run skips both."""
    from legommenders_tpu_torch import process, worker
    from legommenders_tpu_torch.config.dotfiles import AuthInit

    uri, state, stop = _stub_server()
    cwd = os.getcwd()
    os.chdir(tmp)
    real_call = worker.subprocess.call
    worker.subprocess.call = lambda cmd, env: real_call(
        cmd, env=env, timeout=WORKER_TIMEOUT_S)
    try:
        with open(".auth", "w") as f:
            f.write(f"lego_uri: {uri}\nlego_auth: smoke\n")
        AuthInit.reload()
        data_dir = os.path.join(tmp, "data", "synthetic")
        process.main(["--data", "synthetic", "--save_dir", data_dir])
        with open("jobs.txt", "w") as f:
            f.write(WORKER_JOB.format(data_dir=data_dir) + "\n")
        argv = ["--jobs", "jobs.txt", "--replicate", str(WORKER_SEEDS)]
        t0 = time.perf_counter()
        ran = worker.main(argv)
        rec = {"path": "worker + lego-server stub",
               "s": time.perf_counter() - t0, "ran": ran}
        rec["again"] = worker.main(argv)
    finally:
        worker.subprocess.call = real_call
        if os.path.exists(".auth"):
            os.remove(".auth")
        AuthInit.reload()
        os.chdir(cwd)
        stop()
    exps = [e for ev in state["evaluations"].values()
            for e in ev["experiments"]]
    rec["experiments"] = [
        {"seed": e["seed"], "registered": e["pid"] is not None,
         "completed": e["is_completed"],
         "performance": json.loads(e.get("performance") or "{}")}
        for e in exps]
    ok = (len(ran) == WORKER_SEEDS and all(r == 0 for _, _, r in ran)
          and rec["again"] == [] and len(exps) == WORKER_SEEDS
          and all(e["registered"] and e["completed"]
                  and "GAUC" in e["performance"]
                  for e in rec["experiments"]))
    if not ok:
        raise RuntimeError(f"worker failed: {rec}")
    return rec


def run_dp_check(data, device, tmp) -> dict:
    """12.6: NAML at the fixture through the Trainer, DP_STEPS host
    batches of DP_BATCH (an epoch of one step each, with its dev pass),
    plain and under `exp.policy.mesh: true` in an NCCL group of one, both
    `deterministic`: losses, weights and dev values equal bit for bit, the
    same launches (the pool 2 a step and one a cache page), each step
    timed to the card's end; the group destroyed after."""
    import torch
    import torch.distributed as dist
    from legommenders_tpu_torch.parallel import mesh
    from legommenders_tpu_torch.runtime.manager import Manager

    # the fixture holds 38,943 positive training rows: 2 batches of 16,384
    # an epoch; DP_STEPS epochs of one step each, a dev pass after each
    policy = {**PHASE12_POLICY, "batch_size": DP_BATCH, "epoch": DP_STEPS,
              "epoch_batch": 1}
    rec = {"path": f"NAML Trainer, dp 1 (NCCL) vs plain, {DP_STEPS} steps "
                   f"of {DP_BATCH}"}
    runs = {}
    for side in ("plain", "dp"):
        if side == "dp":
            rank, size = mesh.initialize_multihost(
                f"file://{tmp}/nccl_group", 1, 0, device=device)
            rec["group"] = {"rank": rank, "size": size,
                            "backend": dist.get_backend()}
        try:
            p = {**policy, "mesh": True} if side == "dp" else policy
            m = Manager(model_cfg=MODEL_CFG, exp_cfg={"policy": p},
                        data=data, device=device, seed=0)
            tr, timer = _timed_trainer(m)
            _zero_counts()
            with deterministic():
                tr.train()
            torch.cuda.synchronize()
            runs[side] = (m, tr)
            step_s = timer.samples["step"]
            rec[side] = {"launches": _counts(), "losses": tr.losses,
                         "dev": [e["dev"] for e in tr.epochs],
                         "step_ms": statistics.median(step_s[1:]) * 1e3,
                         "step_ms_all": [s * 1e3 for s in step_s],
                         "mesh": dict(m.mesh.shape) if m.mesh else None}
        finally:
            if side == "dp":
                mesh.shutdown()
    rec["group_destroyed"] = not dist.is_initialized()
    (mp, tp), (md, td) = runs["plain"], runs["dp"]
    sd_p, sd_d = mp.model.state_dict(), md.model.state_dict()
    rec["weights_bit_equal"] = all(_bit_equal(sd_p[k], sd_d[k])
                                   for k in sd_p)
    rec["losses_equal"] = tp.losses == td.losses
    rec["dev_equal"] = rec["plain"]["dev"] == rec["dp"]["dev"]
    rec["expected_pool_launches"] = DP_STEPS * (2 + _eval_pages(mp))
    if not (rec["weights_bit_equal"] and rec["losses_equal"]
            and rec["dev_equal"] and rec["group_destroyed"]
            and rec["dp"]["launches"] == rec["plain"]["launches"]
            and rec["dp"]["launches"]["additive_pool"]
            == rec["expected_pool_launches"]
            and len(td.losses) == DP_STEPS):
        raise RuntimeError(f"dp failed: {rec}")
    del runs, mp, md, tp, td
    torch.cuda.empty_cache()
    return rec


def run_phase12(data, device, card) -> dict:
    """Phase 12: the drivers (extractor, splitter, sizer, embed), the worker
    with a lego-server stub, and the dp axis."""
    import tempfile

    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["extractor"] = r = run_extractor_check(data, device, tmp)
        log(f"[drivers] {json.dumps(r)}")
        log(f"[drivers] extractor: {r['shapes']} reprs in {r['s']:.2f} s, "
            f"bit-equal to Tester's cache {r['bit_equal']}, pool launches "
            f"{r['launches']['additive_pool']} (the code's "
            f"{r['expected_pool_launches']}) ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        data16 = SyntheticProcessor(**DOTS_DATA_KW).as_lego_data()
        out["splitter"] = r = run_splitter_check(data16, device, tmp)
        del data16
        log(f"[drivers] {json.dumps(r)}")
        log(f"[drivers] splitter --layers {SPLIT_LAYERS} -> {r['layers']} "
            f"over {r['catalog']} items: {r['s']:.2f} s, {r['bytes']} bytes "
            f"on disk, attention launches {r['launches']['packed_attention']}"
            f" (the code's {r['expected_attention_launches']}); the Trainer "
            f"reading it: init {r['disk']['init']['s']:.2f} s with "
            f"{r['disk']['init']['launches']['packed_attention']} attention "
            f"launches, building it: {r['memory']['init']['s']:.2f} s with "
            f"{r['memory']['init']['launches']['packed_attention']}; caches "
            f"and losses equal: {r['cache_bit_equal']}, {r['losses_equal']};"
            f" reprs bit-equal {r['reprs_bit_equal']}, rel err "
            f"{r['reprs_rel_err']} (gate {SPLIT_REPR_TOL:g}); sizer "
            f"{r['sizer']['total']} parameters ({r['sizer']['trainable']} "
            f"trainable) ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        out["embed"] = r = run_embed_check(data, device, tmp)
        log(f"[drivers] embed: {json.dumps(r)} ({card})")
    with tempfile.TemporaryDirectory() as tmp:
        out["worker"] = r = run_worker_check(tmp)
        log(f"[drivers] worker: {json.dumps(r)}")
    with tempfile.TemporaryDirectory() as tmp:
        out["dp"] = r = run_dp_check(data, device, tmp)
        log(f"[drivers] {json.dumps(r)}")
        log(f"[drivers] dp 1 over NCCL vs plain ({DP_STEPS} steps of "
            f"{DP_BATCH}): step {r['dp']['step_ms']:.1f} ms vs "
            f"{r['plain']['step_ms']:.1f} ms, losses / weights / dev equal "
            f"{r['losses_equal']} / {r['weights_bit_equal']} / "
            f"{r['dev_equal']}, pool launches "
            f"{r['dp']['launches']['additive_pool']} (the code's "
            f"{r['expected_pool_launches']}), group destroyed "
            f"{r['group_destroyed']} ({card})")
    return {"phase12": out}


# --------------------------------------------------------------------- #
# phase 13: the model-parallel axis and catalog_parallel                 #
# --------------------------------------------------------------------- #
# two rank processes share the one card over gloo (NCCL refuses two ranks
# on one device); each case one step (an epoch of one batch) and a dev pass
P13_RANKS = 2
P13_TIMEOUT_S = 420
P13_POLICY = {"dtype": "bf16", "batch_size": TRAIN_BATCH, "lr": TRAIN_LR,
              "epoch": 1, "epoch_batch": 1, "device_batching": True}
# the attention page whose keep masks the ranks draw at their head offsets
P13_MASK_SEED = 20261017
# the TP cases' catalog: DOTS_DATA_KW's at 2,048 items (4 pages of 512),
# for the time limit (the other cases take its 16,384); its 5,000 users
# fill a batch of 2,048 clicks
P13_SMALL_DATA_KW = dict(DOTS_DATA_KW, num_items=2048)
# Adam's eps (runtime/steps.adam): a gradient past 50 eps takes a first
# step within 2 % of +-lr
ADAM_EPS = 1e-8


# (model config, exp.policy.mesh, test after training, dtype, data:
# "catalog" the 16,384-item catalog or "small" P13_SMALL_DATA_KW's)
P13Case = collections.namedtuple("P13Case", "cfg mesh test dtype data",
                                 defaults=(False, "bf16", "catalog"))


def _p13_bert(dropout: float, lm_dtype=None) -> dict:
    """bert-naml layer-split as phase 5 trains it (tune_from 10, `ffn`
    remat, pages of 512), evaluated through its caches, at `dropout`
    (hidden and attention), its LM in `lm_dtype` where given."""
    import copy

    cfg = copy.deepcopy(BERT_TRAIN_CFG)
    cfg["config"]["use_fast_eval"] = True
    cfg["config"]["item_config"].update(dropout=dropout, attn_dropout=dropout)
    if lm_dtype:
        cfg["config"]["item_config"]["lm_dtype"] = lm_dtype
    return cfg


def p13_cases() -> dict:
    """name -> P13Case. "bert-naml mp 2 f32" is the bf16 case at f32:
    TP's own error, apart from bf16's. Both TP cases run on the small
    catalog, for the time limit (the bf16 step took 23-38 s a rank over
    gloo on the 16,384 items, NVIDIA H100 80GB HBM3 at 700 W: ~384
    all-reduces of 63 MB through host memory)."""
    return {
        "bert-naml mp 2": P13Case(_p13_bert(TRAIN_DROPOUT), {"mp": 2},
                                  data="small"),
        "bert-naml mp 2 f32": P13Case(_p13_bert(TRAIN_DROPOUT, "f32"),
                                      {"mp": 2}, dtype="f32", data="small"),
        "dcnv2_id mp 2": P13Case(zoo_cfg("dcnv2_id"), {"mp": 2}),
        "naml mp 2": P13Case(MODEL_CFG, {"mp": 2, "min_rows_to_shard": 0}),
        "bert-naml catalog_parallel": P13Case(
            _p13_bert(0.0), {"catalog_parallel": True}, test=True),
    }


def _p13_data(case: P13Case) -> dict:
    """The SyntheticProcessor arguments of a case's data."""
    return DOTS_DATA_KW if case.data == "catalog" else P13_SMALL_DATA_KW


def _p13_params(m) -> dict:
    """The trainable tensors (this rank's slices), f32 on the host."""
    return {n: p.detach().float().cpu()
            for n, p in m.model.named_parameters() if p.requires_grad}


def p13_run(name: str, case: P13Case, mesh_cfg, data, device, tmp,
            policy=None, pages: int = 0, perturb=None) -> dict:
    """One case through Manager + Trainer (train: one step and a dev pass;
    `case.test`: Trainer.test() after), `deterministic`, its launch counts
    set to 0 just before and read just after; without `mesh_cfg` one
    process. Returns the trainable tensors before the step and after it
    and their gradients (this rank's slices), the losses, the dev value,
    the launches and the plan; with `pages`, the scores of the first
    `pages` test pages by full forwards on the initial weights and their
    launches. `policy` replaces P13_POLICY; `perturb(m)` runs after the
    Trainer's init."""
    import torch
    from legommenders_tpu_torch.parallel.mesh import (
        model_plan, no_pipeline, set_pp_mesh, set_sp_mesh,
    )
    from legommenders_tpu_torch.runtime.manager import Manager

    policy = dict(policy or P13_POLICY, dtype=case.dtype)
    if mesh_cfg is not None:
        policy["mesh"] = mesh_cfg
    m = Manager(model_cfg=case.cfg, exp_cfg={"policy": policy}, data=data,
                device=device, seed=0)
    ckpt = (os.path.join(tmp, "bert-naml.ckpt")
            if mesh_cfg is not None and name == "bert-naml mp 2" else None)
    tr, timer = _timed_trainer(m, ckpt_path=ckpt)
    rec = {"path": name, "mesh": dict(m.mesh.shape) if m.mesh else None}
    t0 = time.perf_counter()
    tr.init()
    if perturb is not None:
        perturb(m)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rec["before"] = _p13_params(m)
    if pages:
        # the first test pages by full forwards on the initial weights,
        # under the Trainer's meshes (the serial layer stack, as every
        # evaluation runs)
        sub = tr.evaluator.phase("test")
        n_all, sub.n = sub.n, min(pages * tr.evaluator.batch_size, sub.n)
        _zero_counts()
        with torch.inference_mode(), no_pipeline():
            rec["scores"] = tr.evaluator.score_phase_device_full(
                "test").float().cpu()
        rec["score_launches"] = _counts()
        sub.n = n_all
    _zero_counts()
    t0 = time.perf_counter()
    with deterministic():
        tr.train()
        if case.test:
            rec["test"] = tr.test()
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - t0
    rec["launches"] = _counts()
    rec["offsets"] = _offsets()
    set_sp_mesh(None)
    set_pp_mesh(None)
    rec["step_ms"] = [s * 1e3 for s in timer.samples["step"]]
    rec["losses"] = tr.losses
    rec["dev"] = [e["dev"] for e in tr.epochs]
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    plan = model_plan(m.model)
    rec["plan"] = dict(plan.sharded) if plan else {}
    rec["pools"] = (_pools_of(m.model.item_op), _pools_of(m.model.user_op))
    rec["tensors"] = _p13_params(m)
    rec["grads"] = {n: p.grad.detach().float().cpu()
                    for n, p in m.model.named_parameters()
                    if p.requires_grad and p.grad is not None}
    if m.catalog_parallel:
        rec["local_rows"] = {c: int(a.shape[0]) for c, a in
                             m.catalog_contents().items()}
    rec["ckpt"] = ckpt
    del tr, m
    torch.cuda.empty_cache()
    return rec


def p13_masks(device, head_offset: int, heads: int):
    """The keep mask of the training page's heads [o, o + heads) (171
    rows of T 120) for P13_MASK_SEED at dropout 0.1."""
    import torch
    from legommenders_tpu_torch.ops.attention import dropout_keep_mask

    B, _, T = mask_shape(TRAIN_PAGE)
    seed = torch.tensor([P13_MASK_SEED], dtype=torch.int32, device=device)
    return dropout_keep_mask(heads, TRAIN_DROPOUT, B, T, seed,
                             head_offset=head_offset)


def p13_attention_offsets(device) -> dict:
    """The forward and backward kernels at a TP rank's heads, dropout
    0.1: bert-naml's training page (12 heads of 64, bf16 and f32) and the
    Llama training page (32 heads of 128, bf16), each cut in two by heads
    and each half run at its head offset (0 and H / 2). Every output and
    gradient must equal the whole page's call's head slice bit for bit
    (each head is computed alike) and lie within the kernel's gate of the
    plain versions given the mask kernel's mask at that offset (bf16:
    BF16_REL_TOL of the largest value, f32: F32_TOL). Comparison launches,
    counted on no path."""
    import torch
    from legommenders_tpu_torch.ops.attention import (
        dropout_keep_mask, packed_attention, packed_attention_backward,
        reference_attention, reference_attention_backward,
    )

    p = TRAIN_DROPOUT
    seed = torch.tensor([P13_MASK_SEED], dtype=torch.int32, device=device)
    llama = DECODER_PAGES["llama training"]
    pages = (
        ("bert bf16", TRAIN_PAGE["heads"], "bf16", lambda: attention_inputs(
            torch.bfloat16, device, seed=11, page=TRAIN_PAGE)),
        ("bert f32", TRAIN_PAGE["heads"], "f32", lambda: attention_inputs(
            torch.float32, device, seed=11, page=TRAIN_PAGE)),
        ("llama bf16", llama["heads"], "bf16",
         lambda: decoder_attention_inputs(llama, torch.bfloat16, device,
                                          5)[:4]))
    out, problems = {}, []
    for label, H, dtype_name, make in pages:
        q, k, v, bias = make()
        g = torch.randn(q.shape, generator=torch.Generator(
            device=device).manual_seed(12), device=device).to(q.dtype)
        B, T, Dm = q.shape
        half, width = H // 2, Dm // 2
        with torch.no_grad():
            whole = (packed_attention(H, p, q, k, v, bias, seed),) + tuple(
                packed_attention_backward(H, p, q, k, v, bias, seed, g))
            for r in range(2):
                cols = slice(r * width, (r + 1) * width)
                qr, kr, vr, gr = (t[..., cols].contiguous()
                                  for t in (q, k, v, g))
                o = r * half
                got = (packed_attention(half, p, qr, kr, vr, bias, seed,
                                        head_offset=o),) + tuple(
                    packed_attention_backward(half, p, qr, kr, vr, bias,
                                              seed, gr, head_offset=o))
                keep = dropout_keep_mask(half, p, B, T, seed, head_offset=o)
                want = (reference_attention(half, p, qr, kr, vr, bias,
                                            keep),) + tuple(
                    reference_attention_backward(half, p, qr, kr, vr, bias,
                                                 gr, keep))
                torch.cuda.synchronize()
                rec = {"B": B, "T": T, "heads": half, "head_offset": o,
                       "dtype": dtype_name}
                for name, a, w, ref in zip(("out", "dq", "dk", "dv"), got,
                                           whole, want):
                    err = (a.float() - ref.float()).abs().max().item()
                    rel = err / ref.float().abs().max().item()
                    equal = torch.equal(a, w[..., cols])
                    rec[name] = {"equals_whole_slice": equal,
                                 "max_abs_err": err, "rel_err": rel}
                    finite = bool(torch.isfinite(a.float()).all())
                    if not (equal and finite) or (
                            err > F32_TOL if dtype_name == "f32"
                            else rel > BF16_REL_TOL):
                        problems.append(f"{label} offset {o} {name}")
                out[f"{label} offset {o}"] = rec
                del got, want, keep
        del q, k, v, bias, g, whole
        torch.cuda.empty_cache()
    if problems:
        raise RuntimeError(f"phase 13: the attention kernels at a head "
                           f"offset disagree ({problems}): "
                           f"{json.dumps(out)[:4000]}")
    return out


def p13_rank(tmp: str) -> dict:
    """A rank of phase 13 (in a gloo group on cuda:0, parallel/launch.py):
    every case at its mesh; its records."""
    import pickle

    import torch
    from legommenders_tpu_torch.parallel import mesh

    rank = mesh.world()[0]
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(tmp, "data.pkl"), "rb") as f:
        datas = pickle.load(f)
    out = {"group": {"backend": torch.distributed.get_backend(),
                     "rank": rank}}
    for name, case in p13_cases().items():
        out[name] = p13_run(name, case, case.mesh, datas[case.data],
                            device, tmp)
    out["mask"] = p13_masks(device, 6 * rank, 6).cpu()
    return out


def _p13_whole(ranks, name: str, key: str) -> dict:
    """The mp shards of the two ranks' `key` tensors, whole."""
    import torch

    plan = ranks[0][name]["plan"]
    return {k: (torch.cat([r[name][key][k] for r in ranks], dim=plan[k])
                if k in plan else v)
            for k, v in ranks[0][name][key].items()}


def _p13_worst(errs: dict) -> tuple:
    """(the largest error, the three worst tensors) of an error dict."""
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    return (worst[0][1] if worst else 0.0), worst


def _p13_scale(k: str, want: dict) -> float:
    """The largest value tensor k of `want` is held against, by
    `_plan_scale`'s rule (a bias against the larger of its own and its
    weight's; its own where the weight is not in `want`)."""
    ref = k
    if k.endswith("proj_bias"):
        ref = k[:-len("proj_bias")] + "proj_kernel"
    elif k.endswith(".bias"):
        ref = k[:-len("bias")] + "weight"
    return _plan_scale(k, want if ref in want else {k: want[k],
                                                    ref: want[k]})


def _p13_errs(got: dict, want: dict) -> dict:
    """Each tensor's max |got - want| over `_p13_scale`."""
    return {k: float((got[k] - w).abs().max()) / _p13_scale(k, want)
            for k, w in want.items()}


def _p13_update_errs(got: dict, got0: dict, want: dict, want0: dict,
                     grads: dict, allow: dict) -> tuple:
    """Each tensor's largest difference of the two updates (after less
    before) over lr, and the share of elements left out. Left out: an
    element whose gradient in `grads` (one process's) is within `allow[k]`
    of `_p13_scale`, where the gradient gate lets it take the other sign
    (a zero-initialised lora_B's; the key bias's, zero in exact math), or
    within 50 Adam eps, where the step is a share of lr that the
    gradient's error moves: Adam's first step is lr g / (|g| + eps), +-lr
    beyond those. A skipped or doubled update reads 1, a flipped one 2. A
    tensor without a gradient: every element."""
    errs, out, total = {}, 0, 0
    for k, w in want.items():
        du = (got[k] - got0[k]) - (w - want0[k])
        total += du.numel()
        if k in grads:
            g = grads[k].abs()
            keep = g > max(allow[k] * _p13_scale(k, grads), 50 * ADAM_EPS)
            out += int((~keep).sum())
            du = du[keep]
        errs[k] = float(du.abs().max()) / TRAIN_LR if du.numel() else 0.0
    return errs, out / max(total, 1)


def _p13_bf16_rule(got: dict, want16: dict, want32: dict) -> tuple:
    """The bf16 TP gradients' gate, every tensor: its error against one
    process's bf16 gradient within BF16_REL_TOL, or within one process's
    own bf16 error (its bf16 gradient against its f32 one) where that is
    larger. precision_check allows half that, for kernels that only
    reorder f32 sums; a TP rank also rounds each row-parallel partial
    product to bf16 before the all-reduce (Megatron's and GSPMD's bf16
    do the same), one more rounding a layer than one process: a
    difference the size of bf16's own error (the softmax-fed tensors:
    the query LoRA, the item pool: precision_check's notes). TP's own
    error is held apart from bf16's by the f32 case. Returns ({"excess":
    the largest error over its allowance, times BF16_REL_TOL (at most
    BF16_REL_TOL when every tensor passes), "over": every tensor past
    2e-2 as (error, own error, error against f32)}, each tensor's
    allowance)."""
    excess, over, allow = 0.0, {}, {}
    errs, owns = _p13_errs(got, want16), _p13_errs(want16, want32)
    to32 = _p13_errs(got, want32)
    for k, err in errs.items():
        allow[k] = max(BF16_REL_TOL, owns[k])
        excess = max(excess, err / allow[k] * BF16_REL_TOL)
        if err > BF16_REL_TOL:
            over[k] = (err, owns[k], to32[k])
    return {"excess": excess, "over": over}, allow


def _p13_check(name: str, case: P13Case, ranks, ref: dict,
               ref32=None, rule=None) -> tuple:
    """(record, problems) of one case: the ranks against one process.
    Gradients and the loss within BF16_REL_TOL (f32: F32_GRAD_TOL; the
    bf16 bert-naml TP case by `_p13_bf16_rule` against `ref32`), each
    update within BF16_REL_TOL of lr (`_p13_update_errs`), the dev value
    and the test metrics within BF16_REL_TOL."""
    keys = ("losses", "dev", "s", "step_ms", "launches", "init_s",
            "peak_memory_gb")
    rec = {"path": name, "mesh": ranks[0][name]["mesh"],
           "dtype": case.dtype, "data": case.data,
           "one": {k: ref[k] for k in keys},
           "ranks": [{k: r[name][k] for k in keys} for r in ranks],
           "sharded": sorted(ranks[0][name]["plan"])[:8],
           "n_sharded": len(ranks[0][name]["plan"])}
    tol = F32_GRAD_TOL if case.dtype == "f32" else BF16_REL_TOL
    got_g = _p13_whole(ranks, name, "grads")
    if ref32 is not None:
        rec["grads_rule"], allow = (rule or _p13_bf16_rule)(
            got_g, ref["grads"], ref32["grads"])
        rec["grads_err"] = rec["grads_rule"]["excess"]
        rec["grads_worst"] = _p13_worst(_p13_errs(got_g, ref["grads"]))[1]
    else:
        rec["grads_err"], rec["grads_worst"] = _p13_worst(
            _p13_errs(got_g, ref["grads"]))
        allow = dict.fromkeys(ref["grads"], tol)
    upd, rec["update_left_out"] = _p13_update_errs(
        _p13_whole(ranks, name, "tensors"), _p13_whole(ranks, name, "before"),
        ref["tensors"], ref["before"], ref["grads"], allow)
    rec["update_err"], rec["update_worst"] = _p13_worst(upd)
    # no step or no dev pass reads inf
    rec["loss_err"] = max((abs(a - b) / max(abs(b), 1e-12) for a, b in
                           zip(ranks[0][name]["losses"], ref["losses"])),
                          default=math.inf)
    rec["dev_err"] = max((abs(a - b) for a, b in
                          zip(ranks[0][name]["dev"], ref["dev"])),
                         default=math.inf)
    gates = {"grads_err": tol, "loss_err": tol, "update_err": BF16_REL_TOL,
             "dev_err": BF16_REL_TOL}
    if "test" in ref:
        rec["test"] = ranks[0][name]["test"]
        rec["test_one"] = ref["test"]
        rec["test_err"] = max(abs(rec["test"][k] - v)
                              for k, v in ref["test"].items())
        gates["test_err"] = BF16_REL_TOL
    rec["gates"] = gates
    if "local_rows" in ranks[0][name]:
        rec["local_rows"] = ranks[0][name]["local_rows"]
    problems = [f"{name} {k} {rec[k]:.3e} > {g:g}" for k, g in gates.items()
                if not rec[k] <= g]
    launches = [r[name]["launches"] for r in ranks]
    if name.startswith("bert") and not all(
            c["packed_attention"] and c["packed_attention_backward"]
            for c in launches):
        problems.append(f"{name}: no attention launch")
    if not all(c["additive_pool"] for c in launches):
        problems.append(f"{name}: no pool launch")
    if "mp" in case.mesh and not ranks[0][name]["plan"]:
        problems.append(f"{name}: nothing sharded")
    return rec, problems


def run_phase13(device, card) -> dict:
    """Phase 13: NAML (row-sharded tables), dcnv2_id (expert-sharded
    CrossNetMix) and bert-naml (Megatron TP at dropout 0.1, bf16 and f32)
    at mp 2, and bert-naml catalog-parallel, two ranks on the card over
    gloo, each held against one process from the same weights and
    batches, on the 16,384-item catalog (DOTS_DATA_KW; the TP cases on
    P13_SMALL_DATA_KW's 2,048); the attention kernels at a head offset
    against the whole page's call and their plain versions."""
    import pickle
    import tempfile

    import torch
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.parallel import launch
    from legommenders_tpu_torch.runtime.checkpoint import load_auto
    from legommenders_tpu_torch.runtime.manager import Manager

    out = {}
    cases = p13_cases()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datas = {"catalog": SyntheticProcessor(**DOTS_DATA_KW).as_lego_data(),
                 "small": SyntheticProcessor(
                     **P13_SMALL_DATA_KW).as_lego_data()}
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump(datas, f)
        out["data_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        group = launch.start(p13_rank, P13_RANKS, (tmp,), "cuda",
                             P13_TIMEOUT_S)
        one = {}
        try:
            t0 = time.perf_counter()
            for name, case in cases.items():
                one[name] = p13_run(name, case, None, datas[case.data],
                                    device, tmp)
            # the f32 gradients the bf16 rule measures bert-naml's own
            # bf16 error by: the f32 TP case's one process
            one32 = one["bert-naml mp 2 f32"]
            whole_mask = p13_masks(device, 0, 12).cpu()
            out["one_process_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["attention_offsets"] = p13_attention_offsets(device)
            out["offsets_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranks = group.wait()
            out["ranks_wait_s"] = time.perf_counter() - t0
        finally:
            group.stop()
        out["group"] = ranks[0]["group"]
        out["masks_equal"] = all(torch.equal(
            ranks[r]["mask"], whole_mask[:, 6 * r:6 * r + 6])
            for r in range(P13_RANKS))
        problems = [] if out["masks_equal"] else ["keep masks"]
        for name, case in cases.items():
            out[name], bad = _p13_check(
                name, case, ranks, one[name],
                one32 if name == "bert-naml mp 2" else None)
            problems += bad
        # the bert-naml mp 2 best checkpoint, read whole in one process
        ckpt = ranks[0]["bert-naml mp 2"]["ckpt"]
        m = Manager(model_cfg=_p13_bert(TRAIN_DROPOUT),
                    exp_cfg={"policy": dict(P13_POLICY)},
                    data=datas[cases["bert-naml mp 2"].data], device=device,
                    seed=1)
        load_auto(ckpt, m.model, model_only=True)
        got = _p13_whole(ranks, "bert-naml mp 2", "tensors")
        named = dict(m.model.named_parameters())
        out["ckpt_bit_equal"] = all(
            torch.equal(named[k].detach().float().cpu(), v)
            for k, v in got.items())
        out["ckpt_dir_files"] = sorted(os.listdir(ckpt + ".orbax"))
        if not out["ckpt_bit_equal"]:
            problems.append("checkpoint read whole")
        del m
        torch.cuda.empty_cache()
        if problems:
            raise RuntimeError(f"phase 13 failed ({problems}): "
                               f"{json.dumps(out, default=str)[:6000]}")
    for name in cases:
        r = out[name]
        log(f"[mp] {name} ({r['mesh']}, {r['dtype']}): step "
            f"{r['ranks'][0]['step_ms']} ms vs one process "
            f"{r['one']['step_ms']} ms, train + dev "
            f"{r['ranks'][0]['s']:.2f} s vs {r['one']['s']:.2f} s; grads / "
            f"update / loss / dev err {r['grads_err']:.2e} / "
            f"{r['update_err']:.2e} (of lr; {r['update_left_out']:.2%} of "
            f"elements left out) / {r['loss_err']:.2e} / {r['dev_err']:.2e} "
            f"(gates {r['gates']}); launches rank 0 "
            f"{r['ranks'][0]['launches']}, rank 1 "
            f"{r['ranks'][1]['launches']}, one process "
            f"{r['one']['launches']} ({card}; two ranks share the card over "
            f"gloo: no multi-card speed)")
    offs = out["attention_offsets"]
    worst = max(v[t]["rel_err"] for v in offs.values()
                for t in ("out", "dq", "dk", "dv"))
    log(f"[mp] keep masks at head offsets 0 and 6 equal the 12-head mask's "
        f"slices: {out['masks_equal']}; the attention forward and backward "
        f"at a TP rank's heads equal the whole page's head slice bit for "
        f"bit and their plain versions ({', '.join(offs)}): worst rel err "
        f"{worst:.2e}; the mp-2 checkpoint ({out['ckpt_dir_files']}) read in "
        f"one process bit for bit: {out['ckpt_bit_equal']}; data "
        f"{out['data_s']:.2f} s, one process {out['one_process_s']:.2f} s, "
        f"the offsets {out['offsets_s']:.2f} s, then the ranks "
        f"{out['ranks_wait_s']:.2f} s")
    log(f"[mp] {json.dumps(out, default=str)}")
    return {"phase13": out}


# --------------------------------------------------------------------- #
# phase 14: the sequence-parallel and pipeline-parallel axes             #
# --------------------------------------------------------------------- #
# two rank processes share the one card over gloo, as phase 13's do; this
# process runs every case in one process first, then the ranks run them
# alone (the flatten steps' attention takes tens of GB a process)
P14_RANKS = 2
P14_TIMEOUT_S = 420
# the sp cases' fixture: DOTS_DATA_KW's catalog and users, the histories
# cut to 30 clicks (L 990 = 30 x 33: JAX's shard_map needs L % sp == 0;
# phase 10.4's 31 give 1,023) and 14 (L 462), the dev and test rows those
# of the first 250 users (~3,000 rows: 6 full-forward pages of 512 a dev
# pass), for the time limit (500 until phase 15 took its seconds)
P14_SP_USERS = 250
P14_CLICKS = {"flatten_transformer": 30, "flatten_fastformer": 14}
# test pages scored after the step, by full forwards
P14_TEST_PAGES = 2
# the f32 case's batches: a quarter of phase 10.4's, for memory (one
# process's bf16 step at batch 128 peaks at 31 GB, NVIDIA H100 80GB HBM3;
# f32 doubles it, beside the ranks)
P14_F32_BATCH, P14_F32_EVAL = 32, 128
# the Llama-7B-width slice of 14.2: 2 layers, d 4,096, 32 heads of 128,
# SwiGLU 10,922, LoRA r 32 on q and v over a frozen bf16 base; a page of
# 128 rows at T 128, causal; pp 2 (one layer a stage, 4 microbatches of
# 32 rows)
P14_LLAMA = dict(layers=2, dim=4096, heads=32, rows=128, T=128, lora_r=32)


def _p14_flatten(name: str, sp_impl: str = "ulysses") -> dict:
    """A flatten YAML at its defaults with its user operator's
    `sequence_parallel` (and `sp_impl` for the Transformer)."""
    import copy

    cfg = copy.deepcopy(zoo_cfg(name))
    user = cfg["config"].setdefault("user_config", {})
    user["sequence_parallel"] = True
    if name == "flatten_transformer":
        user["sp_impl"] = sp_impl
    return cfg


# name -> (case, train batch, eval batch, the one-process run it is held
# against)
P14Spec = collections.namedtuple("P14Spec", "case batch eval_batch ref")


def p14_cases() -> dict:
    """14.1 (sp 2: flatten_transformer under Ulysses and ring, bf16, and
    under Ulysses at f32; flatten_fastformer, bf16) and 14.2 (bert-naml at
    pp 2, phase 5's layer-split training at dropout 0: JAX keys a staged
    stack's draws per microbatch; on P13_SMALL_DATA_KW's 2,048 items, for
    the time limit: its gloo step took 11-15 s a rank on 16,384)."""
    sp = {"sp": 2}
    tr, ff = "flatten_transformer", "flatten_fastformer"
    return {
        "flatten_transformer sp 2 ulysses": P14Spec(
            P13Case(_p14_flatten(tr), sp, data=tr), 128, 512,
            "flatten_transformer"),
        "flatten_transformer sp 2 ring": P14Spec(
            P13Case(_p14_flatten(tr, "ring"), sp, data=tr), 128, 512,
            "flatten_transformer"),
        "flatten_transformer sp 2 ulysses f32": P14Spec(
            P13Case(_p14_flatten(tr), sp, dtype="f32", data=tr),
            P14_F32_BATCH, P14_F32_EVAL, "flatten_transformer f32"),
        "flatten_fastformer sp 2": P14Spec(
            P13Case(_p14_flatten(ff), sp, data=ff), TRAIN_BATCH,
            4 * TRAIN_BATCH, "flatten_fastformer"),
        "bert-naml pp 2": P14Spec(
            P13Case(_p13_bert(0.0), {"pp": 2}, data="small"), TRAIN_BATCH,
            None, "bert-naml"),
    }


def p14_datas() -> dict:
    """The phase's fixtures: the 16,384-item catalog's histories cut for
    each flatten model with the dev and test rows of P14_SP_USERS users,
    and the 2,048-item catalog (`small`)."""
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    catalog = SyntheticProcessor(**DOTS_DATA_KW).as_lego_data()
    out = {"small": SyntheticProcessor(**P13_SMALL_DATA_KW).as_lego_data()}
    for name, clicks in P14_CLICKS.items():
        out[name] = cut_history(catalog, clicks, P14_SP_USERS)
    return out


def p14_run(name: str, spec: P14Spec, mesh_cfg, datas, device,
            tmp) -> dict:
    """One case (p13_run with the spec's batches; the flatten cases score
    P14_TEST_PAGES test pages after the step), and the pools its
    operators run through the kernel."""
    policy = dict(P13_POLICY, batch_size=spec.batch)
    if spec.eval_batch:
        policy["eval_batch_size"] = spec.eval_batch
    flatten = spec.case.data in P14_CLICKS
    return p13_run(name, spec.case, mesh_cfg, datas[spec.case.data],
                   device, tmp, policy=policy,
                   pages=P14_TEST_PAGES if flatten else 0)


def p14_llama_slice(device, mesh=None) -> dict:
    """14.2's Llama-7B-width slice (P14_LLAMA), its weights drawn on the
    card from seed 0 (every LoRA B too: it starts at 0), one page through
    it and the backward of a fixed projection of the output; in one
    process, or staged over `mesh`'s pp axis (the LoRA gradients summed
    over pp). Returns the output, the LoRA gradients (f32 on the host) and
    the attention launches."""
    import torch
    from legommenders_tpu_torch.models.lm.layers import LlamaDecoderSlice
    from legommenders_tpu_torch.parallel import mesh as pmesh

    c = P14_LLAMA
    stages = mesh.pp if mesh is not None else 0
    with torch.device(device):
        sl = LlamaDecoderSlice(c["layers"], c["dim"], num_heads=c["heads"],
                               lora_r=c["lora_r"], freeze_base=True,
                               fused_attention=True, pipeline_stages=stages,
                               dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    sl.reset_parameters(gen)
    with torch.no_grad():
        for n, p in sl.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(0.0, 0.02, generator=gen)
    x = torch.randn(c["rows"], c["T"], c["dim"], generator=gen,
                    device=device).to(torch.bfloat16)
    mask = torch.ones(c["rows"], c["T"], dtype=torch.int32, device=device)
    proj = torch.randn(c["dim"], generator=gen, device=device)
    _zero_counts()
    if mesh is not None:
        with pmesh.pipeline_parallel(mesh):
            y = sl(x, mask)
    else:
        y = sl(x, mask)
    loss = (y.float() @ proj).square().mean()
    loss.backward()
    if mesh is not None:
        pmesh.reduce_gradients([], loss.detach(), mesh,
                               pmesh.partial_params(sl))
    torch.cuda.synchronize()
    out = {"y": y.detach().float().cpu(), "launches": _counts(),
           "grads": {n: p.grad.float().cpu() for n, p in
                     sl.named_parameters() if p.grad is not None}}
    del sl, x, y
    torch.cuda.empty_cache()
    return out


def p14_gloo_all_to_all(device, axis) -> dict:
    """Whether gloo takes CUDA tensors in an all-to-all (Ulysses' transfer
    takes them so): the call on the card against the same call on host
    copies. (Its send and receive take a tensor's data pointer as host
    memory, so a CUDA tensor is not tried there: the port sends through
    host memory.)"""
    import torch
    import torch.distributed as dist

    t = torch.arange(8, dtype=torch.float32, device=device) + 100 * axis.index
    out, host = torch.empty_like(t), torch.empty(8)
    try:
        dist.all_to_all_single(out, t, group=axis.group)
        dist.all_to_all_single(host, t.cpu(), group=axis.group)
        torch.cuda.synchronize()
        return {"direct": "ok", "equal": torch.equal(out.cpu(), host)}
    except Exception as e:  # the probe records what gloo refuses
        return {"direct": f"{type(e).__name__}: {e}"[:300]}


def p14_rank(tmp: str) -> dict:
    """A rank of phase 14 (in a gloo group on cuda:0, parallel/launch.py):
    every case at its mesh and the Llama slice at pp 2; its records."""
    import pickle

    import torch
    from legommenders_tpu_torch.parallel import mesh

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(tmp, "data.pkl"), "rb") as f:
        datas = pickle.load(f)
    out = {"group": {"backend": torch.distributed.get_backend(),
                     "rank": mesh.world()[0]},
           "gloo_all_to_all": p14_gloo_all_to_all(
               device, mesh.mesh_from_policy({"sp": 2}).sp_axis)}
    for name, spec in p14_cases().items():
        t0 = time.perf_counter()
        out[name] = p14_run(name, spec, spec.case.mesh, datas, device, tmp)
        out[name]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["llama slice"] = p14_llama_slice(
        device, mesh.mesh_from_policy({"pp": 2}))
    out["llama slice"]["wall_s"] = time.perf_counter() - t0
    return out


def _p14_expected(name: str, spec: P14Spec, one: dict, m_item_pools: int,
                  m_user_pools: int) -> dict:
    """A rank's launches by the code, from one process's. sp: the user
    pool is the two-psum pool (JAX bypasses its Pallas pool), so a rank
    launches the item pools only. pp (bert-naml, tune_from 10: 2 trained
    layers, pages of 512, `ffn` remat): a stage runs its layers once a
    microbatch, M = 2 x stages, in each page's forward and again in its
    recompute (where the catalog is paged), and their backward once a
    microbatch; the dev pass runs the serial stack on every rank."""
    want = dict(one)
    if "sp" in spec.case.mesh:
        pools = m_item_pools + m_user_pools
        want["additive_pool"] = one["additive_pool"] * m_item_pools // pools
        return want
    cfg = spec.case.cfg["config"]
    stages, layers = spec.case.mesh["pp"], 2
    M, per = 2 * stages, layers // stages
    N, P = _p13_data(spec.case)["num_items"], cfg["item_page_size"]
    pages = -(-N // P) if N > P else 1
    # a paged encode recomputes each page in the backward
    runs = 2 if N > P and cfg["item_page_remat"] != "none" else 1
    want["packed_attention"] = (one["packed_attention"]
                                + pages * runs * (M * per - layers))
    want["packed_attention_backward"] = pages * M * per
    return want


def _p14_slice_errs(got: dict, want: dict) -> dict:
    """The Llama slice's output error over its largest value, and each
    LoRA gradient's over its own largest."""
    errs = {"y": float((got["y"] - want["y"]).abs().max()
                       / want["y"].abs().max())}
    for k, w in want["grads"].items():
        errs[k] = float((got["grads"][k] - w).abs().max()
                        / max(w.abs().max(), 1e-30))
    return errs


def run_phase14(device, card) -> dict:
    """Phase 14: flatten_transformer (Ulysses and ring attention, the
    two-psum pool) and flatten_fastformer (the two-psum pooler) at sp 2,
    bert-naml's trained slice and a Llama-7B-width slice in GPipe stages
    at pp 2 (the attention kernels inside each stage), two ranks on the
    card over gloo, each held against one process from the same weights
    and batches."""
    import pickle
    import tempfile

    import torch
    from legommenders_tpu_torch.parallel import launch

    out = {}
    cases = p14_cases()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datas = p14_datas()
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump(datas, f)
        out["data_s"] = time.perf_counter() - t0
        # one process, every case's reference (ulysses and ring share one)
        t0 = time.perf_counter()
        one = {}
        for name, spec in cases.items():
            if spec.ref not in one:
                one[spec.ref] = p14_run(spec.ref, spec, None, datas, device,
                                        tmp)
        one["llama slice"] = p14_llama_slice(device)
        out["one_process_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch.launch(p14_rank, P14_RANKS, (tmp,), "cuda",
                              P14_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t0
    out["group"] = ranks[0]["group"]
    out["gloo_all_to_all"] = [r["gloo_all_to_all"] for r in ranks]
    problems = []
    for name, spec in cases.items():
        ref = one[spec.ref]
        rec, bad = _p13_check(name, spec.case, ranks, ref)
        rec["ref"] = spec.ref
        rec["wall_s"] = [r[name]["wall_s"] for r in ranks]
        rec["expected"] = _p14_expected(name, spec, ref["launches"],
                                        *ref["pools"])
        for r, rank in enumerate(ranks):
            if rank[name]["launches"] != rec["expected"]:
                bad.append(f"{name} rank {r} launches "
                           f"{rank[name]['launches']} != the code's "
                           f"{rec['expected']}")
        if "scores" in ref:
            rec["score_rows"] = len(ref["scores"])
            scale = float(ref["scores"].abs().max())
            rec["score_err"] = max(
                float((r[name]["scores"] - ref["scores"]).abs().max())
                / scale for r in ranks)
            rec["score_launches"] = [r[name]["score_launches"]
                                     for r in ranks]
            rec["score_launches_one"] = ref["score_launches"]
            tol = F32_TOL if spec.case.dtype == "f32" else BF16_REL_TOL
            if not rec["score_err"] <= tol:
                bad.append(f"{name} scores {rec['score_err']:.3e} > {tol}")
        out[name] = rec
        problems += bad
    # the Llama slice: each rank's output and LoRA gradients
    one_sl = one["llama slice"]
    sl = {"one_launches": one_sl["launches"],
          "launches": [r["llama slice"]["launches"] for r in ranks],
          "wall_s": [r["llama slice"]["wall_s"] for r in ranks]}
    M = 2 * 2
    per = P14_LLAMA["layers"] // 2
    sl["expected"] = {"packed_attention": M * per,
                      "packed_attention_backward": M * per}
    errs = [_p14_slice_errs(r["llama slice"], one_sl) for r in ranks]
    sl["y_err"] = max(e["y"] for e in errs)
    sl["grads_err"], sl["grads_worst"] = _p13_worst(
        {k: max(e[k] for e in errs) for k in errs[0] if k != "y"})
    sl["lora_tensors"] = len(one_sl["grads"])
    out["llama slice"] = sl
    for r, c in enumerate(sl["launches"]):
        for k, v in sl["expected"].items():
            if c[k] != v:
                problems.append(f"llama slice rank {r} {k} {c[k]} != {v}")
    if one_sl["launches"]["packed_attention"] != P14_LLAMA["layers"]:
        problems.append("llama slice: one process's attention launches")
    for key in ("y_err", "grads_err"):
        if not sl[key] <= BF16_REL_TOL:
            problems.append(f"llama slice {key} {sl[key]:.3e}")
    if problems:
        raise RuntimeError(f"phase 14 failed ({problems}): "
                           f"{json.dumps(out, default=str)[:6000]}")
    for name in cases:
        r = out[name]
        tag = "[pp]" if "pp" in r["mesh"] else "[sp]"
        extra = (f"; {r['score_rows']} test rows' scores err "
                 f"{r['score_err']:.2e}, pool launches rank 0 "
                 f"{r['score_launches'][0]['additive_pool']} vs one process "
                 f"{r['score_launches_one']['additive_pool']}"
                 if "score_err" in r else "")
        log(f"{tag} {name} ({r['mesh']}, {r['dtype']}): step "
            f"{r['ranks'][0]['step_ms']} ms vs one process "
            f"{r['one']['step_ms']} ms, train + dev "
            f"{r['ranks'][0]['s']:.2f} s vs {r['one']['s']:.2f} s; grads / "
            f"update / loss / dev err {r['grads_err']:.2e} / "
            f"{r['update_err']:.2e} (of lr; {r['update_left_out']:.2%} "
            f"left out) / {r['loss_err']:.2e} / {r['dev_err']:.2e}{extra}; "
            f"launches rank 0 {r['ranks'][0]['launches']}, rank 1 "
            f"{r['ranks'][1]['launches']} (the code's {r['expected']}), one "
            f"process {r['one']['launches']} ({card}; two ranks share the "
            f"card over gloo: no multi-card speed)")
    sl = out["llama slice"]
    log(f"[pp] Llama-7B-width slice ({P14_LLAMA}) at pp 2: output err "
        f"{sl['y_err']:.2e}, LoRA grads err {sl['grads_err']:.2e} "
        f"(worst {sl['grads_worst']}) against one process; attention "
        f"launches a rank {sl['launches']} (the code's {sl['expected']}), "
        f"one process {sl['one_launches']}; gloo's all-to-all of CUDA "
        f"tensors, direct: {out['gloo_all_to_all']}; data "
        f"{out['data_s']:.2f} s, one "
        f"process {out['one_process_s']:.2f} s, the ranks "
        f"{out['ranks_s']:.2f} s ({card})")
    log(f"[pp] {json.dumps(out, default=str)}")
    return {"phase14": out}


# --------------------------------------------------------------------- #
# phase 15: mesh combinations and catalog-parallel evaluation            #
# --------------------------------------------------------------------- #
# four rank processes (the mp x pp, mp x sp and sp x pp cases) and two
# (the catalog-parallel evaluation) share the card over gloo, both groups
# at once, after this process has run every case in one process
P15_GROUPS = {"four": 4, "two": 2}
P15_TIMEOUT_S = 420
# the fixtures: P13_SMALL_DATA_KW's 2,048 items; the flatten cases' its
# histories cut to 30 clicks (L 990, as phase 14.1's), the catalog-parallel
# evaluation's whole; the dev and test rows of the first P15_USERS users
P15_USERS = 100
# the catalog-parallel evaluation's train / dev batch and eval page: the
# first users' 209 dev positives fill 6 batches (TrainBatcher drops a
# partial tail) and their 1,200 test rows 5 pages
P15_CATALOG_BATCH, P15_CATALOG_PAGE = 32, 256
# name -> (case, train batch, eval batch, the one-process run it is held
# against, the rank group that runs it)
P15Spec = collections.namedtuple("P15Spec",
                                 "case batch eval_batch ref group")
# the pp cases, held by `_p15_bf16_rule` against an f32 run in one
# process too; their ranks also run them at f32 (`_p15_f32_spec`), held
# against one process at f32 by `_p15_f32_rule`: what the bf16 rule
# allows is bf16's rounding, and a dropped microbatch or a missed sum over
# pp or mp fails there
P15_F32 = ("bert-naml mp 2 x pp 2", "bert flatten sp 2 x pp 2")
# how far the f32 ranks' gradient may lie from one process's, in units of
# that gradient's spread under one ulp of input noise (`_p15_f32_rule`):
# two roundings, each about that size
PP_NOISE = 2
# how much further from the f32 gradient a rank's bf16 gradient may lie
# than one process's bf16 gradient does, where bf16's own error exceeds
# BF16_REL_TOL (`_p15_bf16_rule`)
PP_ROUNDING = 1.25


def _p15_sp_pp() -> dict:
    """15.3: flatten_transformer's sequence-parallel user operator (Ulysses)
    beside a 2-layer BERT item operator (item-bert.yaml's configuration,
    the whole LM from its embeddings, dropout 0) at the flatten model's
    width: the user operator reads the same 64-wide token table, so the
    BERT is 64 wide, one head of 64 (BERT-base's head width); pp 2 stages
    its layers one a rank. Dropout 0 on both sides: the staged stack
    draws its seeds per microbatch from the step's generator (JAX keys
    them per microbatch too), so every later draw differs from one
    process's by construction."""
    cfg = _p14_flatten("flatten_transformer")
    cfg["config"]["user_config"]["attention_dropout"] = 0.0
    cfg["meta"] = dict(cfg["meta"], item=BERT_CFG["meta"]["item"])
    cfg["config"]["embedding_dim"] = cfg["config"]["hidden_size"]
    cfg["config"]["item_config"] = dict(
        BERT_CFG["config"]["item_config"], num_hidden_layers=2,
        num_attention_heads=1, dropout=0.0, attn_dropout=0.0)
    return cfg


def _p15_catalog_eval() -> dict:
    """15.4: bert-naml as phase 5 trains it (dropout 0), evaluated by full
    forwards."""
    cfg = _p13_bert(0.0)
    cfg["config"]["use_fast_eval"] = False
    return cfg


def p15_cases() -> dict:
    """15.1 bert-naml at (mp 2, pp 2): Megatron TP inside each GPipe stage,
    6 heads a rank at head offset 0 or 6; 15.2 flatten_transformer at (mp
    2, sp 2) under Ulysses, its tables row-sharded; 15.3 the sp x pp
    composition; 15.4 bert-naml catalog_parallel at dp 2: simple_dev and
    Trainer.test() by full forwards over the reprs each rank encodes of
    its rows. bf16; the pp cases held by `_p15_bf16_rule` against an f32
    one-process run too (P15_F32)."""
    tr = "flatten_transformer"
    return {
        "bert-naml mp 2 x pp 2": P15Spec(
            P13Case(_p13_bert(0.0), {"mp": 2, "pp": 2}, data="small"),
            TRAIN_BATCH, None, "bert-naml", "four"),
        "flatten_transformer mp 2 x sp 2 ulysses": P15Spec(
            P13Case(_p14_flatten(tr), {"mp": 2, "sp": 2}, data=tr), 128, 512,
            "flatten_transformer", "four"),
        "bert flatten sp 2 x pp 2": P15Spec(
            P13Case(_p15_sp_pp(), {"sp": 2, "pp": 2}, data=tr), 128, 512,
            "bert flatten", "four"),
        "bert-naml catalog_parallel dp 2": P15Spec(
            P13Case(_p15_catalog_eval(), {"dp": 2, "catalog_parallel": True},
                    test=True, data="eval"),
            P15_CATALOG_BATCH, P15_CATALOG_PAGE, "bert-naml full forward",
            "two"),
    }


def p15_datas() -> dict:
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    small = SyntheticProcessor(**P13_SMALL_DATA_KW).as_lego_data()
    return {"small": small,
            "flatten_transformer": cut_history(
                small, P14_CLICKS["flatten_transformer"], P15_USERS),
            "eval": cut_history(small, P13_SMALL_DATA_KW["history_len"],
                                P15_USERS)}


def p15_run(name: str, spec: P15Spec, mesh_cfg, datas, device, tmp,
            dtype=None, perturb=None) -> dict:
    """One case (p13_run with the spec's batches; the flatten cases score
    P14_TEST_PAGES test pages; the catalog-parallel evaluation takes its
    dev value by simple_dev); `dtype` in place of the case's."""
    policy = dict(P13_POLICY, batch_size=spec.batch)
    if spec.eval_batch:
        policy["eval_batch_size"] = spec.eval_batch
    if spec.case.test:
        policy["simple_dev"] = True
    case = spec.case if dtype is None else spec.case._replace(dtype=dtype)
    if dtype == "f32":
        import copy
        case = case._replace(cfg=copy.deepcopy(case.cfg))
        case.cfg["config"]["item_config"]["lm_dtype"] = "f32"
    flatten = spec.case.data == "flatten_transformer"
    return p13_run(name, case, mesh_cfg, datas[spec.case.data], device, tmp,
                   policy=policy, pages=P14_TEST_PAGES if flatten else 0,
                   perturb=perturb)


def _p15_f32_spec(spec: P15Spec) -> P15Spec:
    """A P15_F32 case as its ranks run it at f32: a flatten case at phase
    14's f32 batches (P14_F32_BATCH, P14_F32_EVAL), for memory (four
    ranks' f32 attention scores over L 990 at 128 / 512 rows overfill the
    card)."""
    if spec.case.data != "flatten_transformer":
        return spec
    return spec._replace(batch=P14_F32_BATCH, eval_batch=P14_F32_EVAL)


def _p15_ulp_noise(m):
    """Every float content column (a layer-split LM's cached hidden
    states, the embeddings) times 1 + 2^-23 n, n standard normal from a
    fixed seed: about one f32 ulp of noise on what the step reads."""
    import torch

    g = torch.Generator(device=m.device).manual_seed(P13_MASK_SEED)
    with torch.no_grad():
        for a in m.contents.columns.values():
            if a.is_floating_point():
                a.mul_(1 + 2.0 ** -23 * torch.randn(
                    a.shape, generator=g, device=a.device, dtype=a.dtype))


def _p15_f32_rule(got: dict, want: dict, noisy: dict) -> tuple:
    """The f32 ranks' gradients' gate, every tensor: its error against one
    process's f32 gradient (`want`) within F32_GRAD_TOL, or within
    PP_NOISE times that gradient's spread under one ulp of noise on what
    the step reads (`noisy`, `_p15_ulp_noise`) where larger. That spread
    is one process's own f32 error at this size: at the initial weights
    the item pool's gradient is a small sum of cancelling terms, and on
    the CPU (`legommenders_tpu_torch/tools/f32_spread.py`, 256 items) its
    query and kernel lie 1.7-2.4e-3 of their largest value from f64 and
    spread 2.0-2.7e-3, tensor by tensor alike. A dropped microbatch or a
    missed sum over pp or mp moves a gradient by a share of it.
    Returns ({"excess": the largest error over its allowance, times
    F32_GRAD_TOL, "over": every tensor past F32_GRAD_TOL as (error,
    spread)}, each tensor's allowance), as `_p13_bf16_rule`."""
    excess, over, allow = 0.0, {}, {}
    errs, spread = _p13_errs(got, want), _p13_errs(noisy, want)
    for k, err in errs.items():
        allow[k] = max(F32_GRAD_TOL, PP_NOISE * spread[k])
        excess = max(excess, err / allow[k] * F32_GRAD_TOL)
        if err > F32_GRAD_TOL:
            over[k] = (err, spread[k])
    return {"excess": excess, "over": over}, allow


def p15_runs() -> list:
    """(label, spec, dtype) of each rank run: every case at its own dtype,
    then the P15_F32 cases at f32."""
    cases = p15_cases()
    return ([(name, spec, None) for name, spec in cases.items()]
            + [(f"{name} f32", _p15_f32_spec(cases[name]), "f32")
               for name in P15_F32])


def p15_rank(group: str, tmp: str) -> dict:
    """A rank of one of phase 15's groups (in a gloo group on cuda:0,
    parallel/launch.py): the group's cases at their meshes; its
    records."""
    import pickle

    import torch

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(tmp, "data.pkl"), "rb") as f:
        datas = pickle.load(f)
    out = {}
    for label, spec, dtype in p15_runs():
        if spec.group != group:
            continue
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[label] = p15_run(label, spec, spec.case.mesh, datas, device,
                             tmp, dtype=dtype)
        out[label]["wall_s"] = time.perf_counter() - t0
        out[label]["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    return out


def _p15_bf16_rule(got: dict, want16: dict, want32: dict) -> tuple:
    """Phase 13's bf16 rule (`_p13_bf16_rule`), where a tensor also passes
    when its error against one process's f32 gradient is within
    PP_ROUNDING times its allowance. Under pp the batch runs in
    microbatches and, under TP, each row-parallel partial product rounds
    to bf16 before the all-reduce: the ranks round a gradient otherwise
    than one process, and where bf16's own error dominates a tensor (the
    item pool's, whose gradient at the initial weights is a small sum of
    cancelling terms: its bf16 error against f32 is ~30 % of its largest
    value in one process itself) two bf16 roundings lie up to the sum of
    their errors apart. The f32 gradient holds both: the ranks' must be
    about as accurate as one process's."""
    rule, allow = _p13_bf16_rule(got, want16, want32)
    to32 = _p13_errs(got, want32)
    excess = 0.0
    for k, err in _p13_errs(got, want16).items():
        excess = max(excess, min(err / allow[k],
                                 to32[k] / (PP_ROUNDING * allow[k]))
                     * BF16_REL_TOL)
    rule["excess"] = excess
    return rule, allow


def _p15_cells(mesh_cfg: dict) -> list:
    """Each (dp, sp, pp) cell's ranks in mp order (their mp slices make
    the whole tensors), by JAX's rank order."""
    from legommenders_tpu_torch.parallel.mesh import AXES, _coords

    dims = tuple(int(mesh_cfg.get(a, 1)) for a in AXES)
    cells = {}
    for r in range(int(math.prod(dims))):
        dp, mp, sp, pp = _coords(r, dims)
        cells.setdefault((dp, sp, pp), []).append(r)
    return list(cells.values())


def _p15_expected(spec: P15Spec, one: dict, pools: tuple,
                  counts=None) -> dict:
    """A rank's launches by the code. sp: the user pool is the two-psum
    pool, so a rank launches the item pools only (phase 14's rule). pp: a
    stage runs its `layers / pp` layers once a microbatch (M = 2 x pp) in
    each training encode of a page (twice where `ffn` recomputes a paged
    catalog) and their backward once a microbatch; dev and test run the
    serial stack; mp changes no count (each TP rank launches at its
    heads). catalog_parallel (`counts`: the dev batches and the test
    pages): a rank encodes its 1 / dp of the catalog's rows once a step
    (and again in the recompute), once for simple_dev and once for the
    test phase, and pools its dp rows' users once a dev batch and a test
    page."""
    mesh = spec.case.mesh
    cfg = spec.case.cfg["config"]
    item_pools, user_pools = pools
    P = int(cfg.get("item_page_size") or 0)
    upper = (BERT_LAYERS - cfg["item_config"]["tune_from"]
             if cfg["item_config"].get("tune_from") else
             cfg["item_config"]["num_hidden_layers"])
    if mesh.get("catalog_parallel"):
        n_dp = mesh["dp"]
        local = -(-P13_SMALL_DATA_KW["num_items"] // n_dp)
        pages = -(-local // P) if 0 < P < local else 1
        runs = 2 if pages > 1 and cfg["item_page_remat"] != "none" else 1
        dev_batches, test_pages = counts
        return dict(one, additive_pool=(
            pages * item_pools * (runs + 2)
            + user_pools * (1 + dev_batches + test_pages)),
            packed_attention=pages * upper * (runs + 2),
            packed_attention_backward=pages * upper)
    want = dict(one)
    if "sp" in mesh:
        want["additive_pool"] = (one["additive_pool"] * item_pools
                                 // (item_pools + user_pools))
    if "pp" in mesh:
        stages = mesh["pp"]
        M, per = 2 * stages, upper // stages
        if spec.case.data == "small":  # the whole catalog, in pages
            N = P13_SMALL_DATA_KW["num_items"]
        else:  # a flatten batch's candidates, 1 + the negatives a row
            N = spec.batch * (1 + int(cfg.get("neg_count") or 4))
        pages = -(-N // P) if 0 < P < N else 1
        runs = 2 if pages > 1 and cfg.get(
            "item_page_remat", "none") != "none" else 1
        want["packed_attention"] = (one["packed_attention"]
                                    + pages * runs * (M * per - upper))
        want["packed_attention_backward"] = pages * M * per
    return want


def _p15_catalog_counts(spec: P15Spec, data) -> tuple:
    """(dev batches of simple_dev, test pages of the full-forward test) of
    the catalog-parallel evaluation case (JAX's page rule, rounded up to
    a multiple of dp)."""
    from legommenders_tpu_torch.data.pipeline import TrainBatcher

    cfg = spec.case.cfg["config"]
    dev = TrainBatcher(data, spec.batch, neg_count=cfg["neg_count"],
                       use_neg_sampling=True, seed=0, phase="dev")
    n = len(data.inters["test"][data.cm.user_col])
    n_dp = spec.case.mesh["dp"]
    page = min(spec.eval_batch or 4 * spec.batch, max(8, n))
    page = -(-page // n_dp) * n_dp
    return len(dev), -(-n // page)


def run_phase15(device, card) -> dict:
    """Phase 15: bert-naml at (mp 2, pp 2) on 2,048 items (the attention
    kernels at each TP rank's head offset inside each stage),
    flatten_transformer at (mp 2, sp 2) under Ulysses, the sp x pp
    composition, four ranks on the card over gloo; bert-naml
    catalog_parallel at dp 2 (simple_dev, Trainer.test() by full forwards
    over the first P15_USERS users), two ranks at the same time; each held
    against one process from the same weights and batches (phase 13's
    gates)."""
    import pickle
    import tempfile

    import torch
    from legommenders_tpu_torch.parallel import launch

    out = {}
    cases = p15_cases()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datas = p15_datas()
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump(datas, f)
        out["data_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = {}
        for name, spec in cases.items():
            one[spec.ref] = p15_run(spec.ref, spec, None, datas, device, tmp)
        for name in P15_F32:
            # the bf16 rule's f32 gradients, at the case's batches; the
            # f32 ranks' reference, at theirs
            spec, spec32 = cases[name], _p15_f32_spec(cases[name])
            one[f"{spec.ref} f32"] = p15_run(f"{spec.ref} f32", spec, None,
                                             datas, device, tmp, dtype="f32")
            one[f"{name} f32"] = (
                one[f"{spec.ref} f32"] if spec32 is spec else p15_run(
                    f"{name} f32", spec32, None, datas, device, tmp,
                    dtype="f32"))
            one[f"{name} f32 noise"] = p15_run(
                f"{name} f32 noise", spec32, None, datas, device, tmp,
                dtype="f32", perturb=_p15_ulp_noise)
            torch.cuda.empty_cache()
        out["one_process_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        # the six ranks share the card with what this process still holds
        out["parent_gb"] = {"allocated": torch.cuda.memory_allocated() / 1e9,
                            "reserved": torch.cuda.memory_reserved() / 1e9}
        t0 = time.perf_counter()
        groups = {g: launch.start(p15_rank, n, (g, tmp), "cuda",
                                  P15_TIMEOUT_S)
                  for g, n in P15_GROUPS.items()}
        try:
            ranks = {g: launched.wait() for g, launched in groups.items()}
        finally:
            for launched in groups.values():
                launched.stop()
        out["ranks_s"] = time.perf_counter() - t0
    problems = []
    runs = p15_runs()
    for name, spec, dtype in runs:
        group = ranks[spec.group]
        if dtype:  # the ranks at f32 against one process at f32
            ref, ref32 = one[name], one[f"{name} noise"]
            case, rule = spec.case._replace(dtype=dtype), _p15_f32_rule
        else:
            ref, ref32 = one[spec.ref], one.get(f"{spec.ref} f32")
            case, rule = spec.case, _p15_bf16_rule
        recs = []
        for cell in _p15_cells(spec.case.mesh):
            rec, bad = _p13_check(name, case, [group[r] for r in cell],
                                  ref, ref32, rule=rule)
            recs.append(rec)
            problems += bad
        rec = recs[0]
        rec["cells"] = len(recs)
        for key in ("grads_err", "update_err", "loss_err", "dev_err"):
            rec[key] = max(c[key] for c in recs)
        rec["wall_s"] = [r[name]["wall_s"] for r in group]
        rec["peak_reserved_gb"] = [r[name]["peak_reserved_gb"]
                                   for r in group]
        rec["launches"] = [r[name]["launches"] for r in group]
        rec["offsets"] = [r[name]["offsets"] for r in group]
        rec["one_launches"] = ref["launches"]
        counts = None
        if spec.case.test:
            counts = rec["dev_batches_test_pages"] = _p15_catalog_counts(
                spec, datas[spec.case.data])
            # simple_dev read dev batches: its mean loss is 0 over none
            if not counts[0] or 0.0 in ref["dev"] or any(
                    0.0 in r[name]["dev"] for r in group):
                problems.append(f"{name}: simple_dev ran no dev batch "
                                f"({counts[0]} batches, dev {ref['dev']})")
        rec["expected"] = _p15_expected(spec, ref["launches"], ref["pools"],
                                        counts)
        for r, c in enumerate(rec["launches"]):
            if c != rec["expected"]:
                problems.append(f"{name} rank {r} launches {c} != the "
                                f"code's {rec['expected']}")
        if "mp" in spec.case.mesh:
            # a TP rank at mp index i launches only at its first head,
            # 12 / mp x i
            from legommenders_tpu_torch.parallel.mesh import AXES, _coords
            dims = tuple(int(spec.case.mesh.get(a, 1)) for a in AXES)
            for r, offs in enumerate(rec["offsets"]):
                heads = (TRAIN_PAGE["heads"] // spec.case.mesh["mp"]
                         * _coords(r, dims)[1])
                for kernel, by in offs.items():
                    if by and set(by) != {heads}:
                        problems.append(f"{name} rank {r} {kernel} at head "
                                        f"offsets {by}, not {heads}")
        if "scores" in ref:
            scale = float(ref["scores"].abs().max())
            rec["score_err"] = max(
                float((r[name]["scores"] - ref["scores"]).abs().max())
                / scale for r in group)
            if not rec["score_err"] <= BF16_REL_TOL:
                problems.append(f"{name} scores {rec['score_err']:.3e}")
        out[name] = rec
    if problems:
        log(f"[mesh15] {json.dumps(out, default=str)}")
        worst = {n: out[n].get("grads_rule", out[n].get("grads_worst"))
                 for n, _, _ in runs}
        raise RuntimeError(f"phase 15 failed ({problems}); worst gradients "
                           f"{json.dumps(worst, default=str)[:6000]}")
    for name, _, _ in runs:
        r = out[name]
        extra = (f"; test metrics err {r['test_err']:.2e}"
                 if "test_err" in r else "")
        extra += (f"; first test pages' scores err {r['score_err']:.2e}"
                  if "score_err" in r else "")
        log(f"[mesh15] {name} ({r['mesh']}, {r['dtype']}, {r['cells']} "
            f"cells): step {r['ranks'][0]['step_ms']} ms vs one process "
            f"{r['one']['step_ms']} ms, train + dev "
            f"{r['ranks'][0]['s']:.2f} s vs {r['one']['s']:.2f} s; grads / "
            f"update / loss / dev err {r['grads_err']:.2e} / "
            f"{r['update_err']:.2e} (of lr) / {r['loss_err']:.2e} / "
            f"{r['dev_err']:.2e}{extra}; launches a rank {r['launches']} "
            f"(the code's {r['expected']}), by head offset {r['offsets']}; "
            f"one process {r['one_launches']} ({card}; the ranks share the "
            f"card over gloo: no multi-card speed)")
    log(f"[mesh15] data {out['data_s']:.2f} s, one process "
        f"{out['one_process_s']:.2f} s, the ranks {out['ranks_s']:.2f} s; "
        f"this process held {out['parent_gb']['reserved']:.2f} GB beside "
        f"them, a rank's case at most "
        f"{max(max(out[n]['peak_reserved_gb']) for n, _, _ in runs):.2f} GB")
    log(f"[mesh15] {json.dumps(out, default=str)}")
    return {"phase15": out}


# --------------------------------------------------------------------- #
# phase 16: the scaling sweep and the multi-chip dry run                 #
# --------------------------------------------------------------------- #
# four rank processes share the card over gloo, as in phase 15
P16_RANKS = 4
P16_TIMEOUT_S = 300
# the full-width points: NRMS at config/model/nrms.yaml's defaults (phase
# 7's: hidden 64, 8 item and 8 user heads) on DATA_KW, batches of
# TRAIN_BATCH, f32, P16_STEPS steps, at dp 4 and (dp 2, mp 2)
P16_POINTS = ((4, 1), (2, 2))
P16_STEPS = 3
# the item encode in pages of P16_PAGE under `full` remat (phase 5's
# knobs): unpaged, a (dp 2, mp 2) rank's f32 encode of the whole catalog
# (local batch 1,024: 2 x 1,024 x 55 occurrences >= 65,000 items) peaks
# near 20 GB (an NVIDIA H100 80GB HBM3 rank held 17.2 GB when it asked
# for 2.1 GB more), and four of them overfill the card
P16_PAGE = 8192
# the pool's f32 shapes on the phase's paths: (N, L, D), H 256
P16_POOLS = {"nrms item page (full width)": (P16_PAGE, 33, 64),
             "nrms user (full width)": (TRAIN_BATCH, 50, 64),
             "entry nrms item": (64, 9, 32),
             "entry nrms user": (16, 8, 32),
             "bert item": (40, 9, 16), "bert ada user": (16, 4, 16),
             "catalog naml item": (100, 9, 16),
             "catalog naml user": (16, 6, 16)}
# the f32 attention pages at head width 8 (2 heads of a width-16 BERT):
# (rows, item length L, items packed a row, shortest valid length); the
# pp point's microbatch (every token valid), the staged Trainer's
# microbatch (40 items / 4 microbatches / dp 2), the serial Trainer's
# packed page (14 items of 9 a row)
P16_ATTENTION = {"pp point microbatch": (2, 6, 1, 6),
                 "staged Trainer microbatch": (5, 9, 1, 4),
                 "serial Trainer page": (3, 9, 14, 4)}
# the sweep's pp point and the dry run's BERT: 2 layers staged over 2
# ranks in 2 x 2 microbatches (the slice's default)
P16_PP = dict(layers=2, stages=2, microbatches=4)


def p16_cfg(page: int = 0) -> dict:
    """NRMS at its YAML's defaults, attention dropout 0 (the sweep's
    points hold step equivalence, which dropout drawn per dp rank would
    break), its item encode in pages of `page` under `full` remat."""
    cfg = zoo_cfg("nrms")
    for side in ("item_config", "user_config"):
        cfg["config"][side]["attention_dropout"] = 0.0
    if page:
        cfg["config"].update(item_page_size=page, item_page_remat="full")
    return cfg


def p16_build(data, page: int):
    """scaling.run_point's `build` of the full-width NRMS on `data`."""
    def build(batch_size, device):
        from legommenders_tpu_torch import graft
        from legommenders_tpu_torch.runtime.manager import Manager

        m = Manager(model_cfg=p16_cfg(page),
                    exp_cfg={"policy": {"batch_size": batch_size,
                                        "lr": 1e-3}},
                    data=data, device=device)
        return m, graft.first_batch(m)
    return build


def p16_full_rank(data_path: str, batch: int, page: int, device) -> dict:
    """A rank of the full-width points: each point in turn on its mesh,
    batches of `batch`, item pages of `page`."""
    import pickle

    import torch
    from legommenders_tpu_torch import graft, scaling

    with open(data_path, "rb") as f:
        data = pickle.load(f)
    out = {}
    cuda = torch.device(device).type == "cuda"
    with graft.f32():
        for n_dp, n_mp in P16_POINTS:
            t0 = time.perf_counter()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            out[(n_dp, n_mp)] = rec = scaling.run_point(
                n_dp, n_mp, batch, P16_STEPS, device,
                build=p16_build(data, page))
            rec["s"] = time.perf_counter() - t0
            rec["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None)
            if cuda:
                torch.cuda.empty_cache()
    return out


def p16_attention_inputs(rows: int, L: int, pack: int, shortest: int,
                         device, seed: int):
    """q, k, v, the output gradient ~ N(0, 1) at width 16 and the bias
    packed_mask_bias makes for rows x pack items of L tokens, their valid
    lengths `shortest` .. L."""
    import torch
    from legommenders_tpu_torch.models.lm.layers import (
        pack_items, packed_mask_bias,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    items = rows * pack
    lens = torch.randint(shortest, L + 1, (items,), generator=g,
                         device=device)
    mask = (torch.arange(L, device=device)[None] < lens[:, None]).int()
    _, mask_p, _ = pack_items(torch.zeros(items, L, 1, device=device), mask,
                              pack)
    B, T = mask_p.shape
    q, k, v, gr = (torch.randn(B, T, 16, generator=g, device=device)
                   for _ in range(4))
    return q, k, v, packed_mask_bias(mask_p, L, torch.float32)[:, 0], gr


def p16_kernel_checks(device) -> dict:
    """16.1: the pool at P16_POOLS and both attention kernels at
    P16_ATTENTION (f32, dropout 0) against their plain versions, within
    F32_TOL."""
    import torch
    from legommenders_tpu_torch.ops.attention import (
        packed_attention, packed_attention_backward, reference_attention,
        reference_attention_backward,
    )

    pools = [check_pool(name, N, L, "f32", device, d=d)
             for name, (N, L, d) in P16_POOLS.items()]
    attention = []
    seed = torch.tensor([4242], dtype=torch.int32, device=device)
    for name, (rows, L, pack, shortest) in P16_ATTENTION.items():
        q, k, v, bias, g = p16_attention_inputs(rows, L, pack, shortest,
                                                device, 16)
        with torch.no_grad():
            out = packed_attention(2, 0.0, q, k, v, bias)
            grads = packed_attention_backward(2, 0.0, q, k, v, bias, seed, g)
            want = reference_attention(2, 0.0, q, k, v, bias)
            wgrads = reference_attention_backward(2, 0.0, q, k, v, bias, g)
        rec = {"page": name, "B": q.shape[0], "T": q.shape[1], "heads": 2,
               "dh": 8, "out_max_abs_err": float((out - want).abs().max()),
               "grad_max_abs_err": max(float((a - b).abs().max())
                                       for a, b in zip(grads, wgrads))}
        attention.append(rec)
        if not (rec["out_max_abs_err"] <= F32_TOL
                and rec["grad_max_abs_err"] <= F32_TOL):
            raise RuntimeError(f"the f32 attention disagrees with its plain "
                               f"version at head width 8: {rec}")
    return {"pools": pools, "attention": attention}


def _p16_point_expected(label: str, steps: int) -> dict:
    """A sweep or full-width point's launches on each rank, by the code:
    an NRMS step pools its items once and its users once (one item
    encode a step, the whole catalog or the batch's occurrences; dp and
    mp change neither); the sp pool is plain torch; the pp point runs the
    serial slice's layers once and the rank's stage once a microbatch,
    forward only; the catalog point pools the catalog and the users once
    in one process's step and once in the sharded step."""
    kind = label.split()[0]
    if kind == "dp":
        return {"additive_pool": 2 * steps}
    if kind == "pp":
        return {"packed_attention": P16_PP["layers"] + P16_PP["microbatches"]
                * P16_PP["layers"] // P16_PP["stages"]}
    if kind == "catalog":
        return {"additive_pool": 4}
    return {}


def _p16_full_expected(n_dp: int, data) -> dict:
    """A full-width point's launches on each rank by the code: a step
    encodes the whole catalog where it holds at most 2 x B x (K + S)
    occurrences (`full_catalog_encode` auto; B the rank's rows), else the
    rows' B x (K + S), in pages of P16_PAGE, each page twice (the forward
    and the `full` recompute) where there is more than one, then pools
    the users once."""
    cfg = p16_cfg(P16_PAGE)["config"]
    B = TRAIN_BATCH // n_dp
    occ = B * (1 + int(cfg["neg_count"]) + data.history_matrix().shape[1])
    M = data.num_items if data.num_items <= 2 * occ else occ
    items = 2 * -(-M // P16_PAGE) if M > P16_PAGE else 1
    return {"additive_pool": P16_STEPS * (items + 1)}


def _p16_trainer_expected(name: str, rec: dict, mesh_cfg, rank: int
                          ) -> dict:
    """A dry-run Trainer pass's launches on one rank by the code (`rec`:
    graft's record of the run; `mesh_cfg`: its mesh policy, None in one
    process): a step pools its rows' items once and users once (mp does
    not split the pool; catalog_parallel pools the rank's catalog rows);
    each evaluation (a dev pass an epoch, then the test) rebuilds the
    repr caches, the items and the users of the rank's dp block in pages,
    one pool a page. The BERT's attention: a step runs each layer forward
    and backward once, or under pp the rank's layers / pp layers once a
    microbatch; a cache page runs every layer forward (evaluation is
    serial). The sp pool is plain torch."""
    from legommenders_tpu_torch.parallel.mesh import AXES, _coords

    if name == "sp":
        return {}
    mesh_cfg = mesh_cfg or {}
    dims = tuple(int(mesh_cfg.get(a) or 1) for a in AXES)
    dp, i, stages = dims[0], _coords(rank, dims)[0], dims[3]
    items, users, page = rec["cache"]

    def pages(n):
        k = -(-n // dp)
        return -(-(min((i + 1) * k, n) - min(i * k, n)) // page)

    steps, evals = rec["steps"], rec["evaluations"]
    want = {"additive_pool": 2 * steps + evals * (pages(items)
                                                  + pages(users))}
    if name == "pp":
        layers = P16_PP["layers"]
        train = (P16_PP["microbatches"] * layers // stages if stages > 1
                 else layers)
        want["packed_attention"] = (steps * train
                                    + evals * pages(items) * layers)
        want["packed_attention_backward"] = steps * train
    return want


def _p16_launch_problems(got: dict, want: dict, where: str) -> list:
    keys = ("additive_pool", "packed_attention", "packed_attention_backward")
    if all(got.get(k, 0) == want.get(k, 0) for k in keys):
        return []
    return [f"{where}: launches {got} != the code's {want}"]


def run_phase16(data, device, card) -> dict:
    """Phase 16: the scaling sweep and the multi-chip dry run (scaling.py,
    graft.dryrun_multichip) with four ranks on the card over gloo, the
    full-width NRMS at dp 4 and (dp 2, mp 2) against one process, each
    rank's launches against the code's count."""
    import pickle
    import tempfile

    import torch
    from legommenders_tpu_torch import graft, scaling
    from legommenders_tpu_torch.parallel import launch

    out = {}
    problems = []
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "data.pkl")
        with open(path, "wb") as f:
            pickle.dump(data, f)
        full = launch.start(p16_full_rank, P16_RANKS,
                            (path, TRAIN_BATCH, P16_PAGE, device.type),
                            device.type, P16_TIMEOUT_S)
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            with graft.f32():
                ref = scaling.run_point(1, 1, TRAIN_BATCH, P16_STEPS, device,
                                        build=p16_build(data, P16_PAGE))
            if cuda:
                ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                torch.cuda.empty_cache()
            out["one_process_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            dry = graft.dryrun_multichip(P16_RANKS, device.type,
                                         timeout=P16_TIMEOUT_S)
            out["dryrun_s"] = time.perf_counter() - t1
            out["checks"] = p16_kernel_checks(device)
            full_ranks = full.wait()
        finally:
            full.stop()
        out["phase_s"] = time.perf_counter() - t0
    # the sweep's records (its asserts held in graft.dryrun_multichip)
    out["records"] = dry["records"]
    out["summary"] = dry["summary"]
    out["launches"] = {}
    for w, ranks in dry["sweep_ranks"].items():
        for r, points in enumerate(ranks):
            for label, res in points.items():
                key = f"sweep {label} (rank {r} of {w}, gloo)"
                out["launches"][key] = res["launches"]
                problems += _p16_launch_problems(
                    res["launches"], _p16_point_expected(
                        label, scaling.STEPS), key)
    out["sweep_s"] = {label: [ranks[r][label]["s"]
                              for r in range(len(ranks))]
                      for ranks in dry["sweep_ranks"].values()
                      for label in ranks[0]}
    key = "dry run pp 1 Trainer (one process)"
    out["launches"][key] = dry["serial"]["launches"]
    problems += _p16_launch_problems(dry["serial"]["launches"],
                                     _p16_trainer_expected(
                                         "pp", dry["serial"], None, 0), key)
    meshes = graft.dryrun_meshes(P16_RANKS)
    for r, passes in enumerate(dry["ranks"]):
        for name, rec in passes.items():
            key = f"dry run {name} (rank {r} of {P16_RANKS}, gloo)"
            out["launches"][key] = rec["launches"]
            problems += _p16_launch_problems(
                rec["launches"], _p16_trainer_expected(
                    name, rec, meshes.get(name), r), key)
    # the full-width points against one process
    out["launches"]["full width (one process)"] = ref["launches"]
    problems += _p16_launch_problems(
        ref["launches"], _p16_full_expected(1, data),
        "full width one process")
    full_recs = []
    for (n_dp, n_mp), res in full_ranks[0].items():
        dev = max(float(abs(res["params"][k] - ref["params"][k]).max())
                  for k in ref["params"])
        rel = abs(res["loss"] - ref["loss"]) / max(1.0, abs(ref["loss"]))
        rec = {"dp": n_dp, "mp": n_mp, "loss": res["loss"],
               "one_process_loss": ref["loss"], "loss_rel_err": rel,
               "max_param_dev_vs_one_process": dev,
               "collective_bytes": res["vol"],
               "s": [rk[(n_dp, n_mp)]["s"] for rk in full_ranks],
               "peak_gb": [rk[(n_dp, n_mp)]["peak_gb"]
                           for rk in full_ranks]}
        full_recs.append(rec)
        if rel > scaling.RTOL or dev >= scaling.PARAM_TOL:
            problems.append(f"full width dp {n_dp} mp {n_mp}: loss rel err "
                            f"{rel:.3e}, params {dev:.3e}")
        if n_mp == 1 and res["vol"] != {
                "all-reduce": 4 * (ref["trainable"] + 1)}:
            problems.append(f"full width dp {n_dp}: {res['vol']} is not "
                            f"one f32 all-reduce of the "
                            f"{ref['trainable']} gradients and the loss")
        for r, rk in enumerate(full_ranks):
            key = f"full width dp {n_dp} mp {n_mp} (rank {r}, gloo)"
            out["launches"][key] = rk[(n_dp, n_mp)]["launches"]
            problems += _p16_launch_problems(
                rk[(n_dp, n_mp)]["launches"], _p16_full_expected(n_dp, data),
                key)
    out["full_width"] = full_recs
    if problems:
        log(f"[scaling] {json.dumps(out, default=str)[:20000]}")
        raise RuntimeError(f"phase 16 failed: {problems}")
    log(f"[scaling] {dry['summary']}")
    for rec in dry["records"]:
        log(f"[scaling] {json.dumps(rec)}")
    for label, s in out["sweep_s"].items():
        log(f"[scaling] sweep point {label}: {max(s):.2f} s ({card}; gloo "
            f"ranks sharing one card)")
    for rec in full_recs:
        log(f"[scaling] full width {json.dumps(rec)} ({card})")
    log(f"[scaling] the full-width one process {out['one_process_s']:.2f} "
        f"s (peak {ref.get('peak_gb')} GB), then the dry run + sweep "
        f"{out['dryrun_s']:.2f} s, beside the full-width ranks; "
        f"{out['phase_s']:.2f} s in all ({card})")
    log(f"[scaling] launches a rank (the code's, checked): "
        f"{json.dumps(out['launches'])}")
    return {"phase16": out}


def _kernel_line(R: dict) -> list:
    """The `kernels` JSON: each kernel's headline check (phase 3's where it
    ran, else the first check of its kind from the phases that ran), its
    launches by main path, and the shape checks of each phase."""
    runs, profiles = {}, {}
    for p, rec in R.get("paths", {}).items():
        runs[p] = rec["launches"]
        profiles[p] = rec["profile"]
    if "lm_train" in R:
        runs["bert-naml lm cache"] = R["lm_train"]["cache_launches"]
        runs["bert-naml training"] = R["lm_train"]["launches"]
        runs["naml training"] = R["naml_train"]["launches"]
        profiles["bert-naml training step"] = R["lm_train"]["profile"]
        profiles["naml training step"] = R["naml_train"]["profile"]
        runs["bert-naml training (full remat)"] = R["lm_train"][
            "full_remat"]["launches"]
        profiles["bert-naml training step (full remat)"] = R["lm_train"][
            "full_remat"]["profile"]
    if "loop" in R:
        runs["naml Trainer (host batches)"] = R["loop"]["launches"]
        runs["naml Trainer (device batches)"] = R["dev_loop"]["launches"]
        runs["naml full-forward test"] = R["full"]["launches"]
        runs["naml latency (cached)"] = R["latency"]["cached_launches"]
        runs["naml latency (full)"] = R["latency"]["full_launches"]
        runs["bert-naml Trainer lm cache"] = R["lm_loop"]["cache_launches"]
        runs["bert-naml Trainer"] = R["lm_loop"]["launches"]
    for key in ("zoo", "ctr"):
        for name, rec in R.get(key, {}).items():
            runs[f"{name} Tester.test()"] = rec["test_launches"]
            runs[f"{name} training"] = rec["train"]["launches"]
            profiles[f"{name} training step"] = rec["train"]["profile"]
    if "plans" in R:
        for side in ("plans", "plain"):
            runs[f"naml training ({side})"] = R["plans"][
                f"step_{side}"]["launches"]
            profiles[f"naml training step ({side})"] = R["plans"][
                f"step_{side}"]["profile"]
    decoder_runs = {}
    if "llama_serve" in R:
        decoder_runs["llama-naml Tester.test()"] = R["llama_serve"][
            "launches"]
        for name, rec in R["decoders"].items():
            decoder_runs[f"{name} lm cache"] = rec["cache_launches"]
            if "test_launches" in rec:
                decoder_runs[f"{name} Tester.test()"] = rec["test_launches"]
            decoder_runs[f"{name} training"] = rec["train"]["launches"]
        profiles["llama-naml serving (8 pages)"] = R["llama_serve"][
            "profile"]
        profiles["llama-naml training step"] = R["decoders"]["llama-naml"][
            "train"]["profile"]
    phase10_runs = {}
    for name, rec in R.get("iisan", {}).items():
        phase10_runs[f"{name} iisan cache"] = rec["cache_launches"]
        phase10_runs[f"{name} Tester.test()"] = rec["test_launches"]
        phase10_runs[f"{name} training"] = rec["train"]["launches"]
        profiles[f"{name} training step"] = rec["train"]["profile"]
        if "trainer" in rec:
            phase10_runs[f"{name} Trainer"] = rec["trainer"]["launches"]
    for name, rec in R.get("bert_zoo", {}).items():
        phase10_runs[f"{name} lm cache"] = {
            "packed_attention": rec["cache_launches"]}
        phase10_runs[f"{name} Tester.test()"] = rec["test_launches"]
        phase10_runs[f"{name} training"] = rec["train"]["launches"]
    for name, rec in R.get("flatten", {}).items():
        phase10_runs[f"{name} Tester.test()"] = rec["test_launches"]
        phase10_runs[f"{name} training"] = rec["train"]["launches"]
        profiles[f"{name} training step"] = rec["train"]["profile"]
    phase11_runs = {}
    knobs = R.get("knobs")
    if knobs:
        for label, r in knobs["steps"].items():
            key = f"bert-naml {label} ({knobs['catalog']} items)"
            phase11_runs[f"{key} training"] = r["launches"]
            profiles[f"{key} training step"] = r["profile"]
        for page in ("glm_fused_qkv", "llama_norm_bf16"):
            r = knobs[page]
            for side in ("off", "on"):
                phase11_runs[f"{r['path']} {side}"] = r[f"launches_{side}"]
    for name, rec in R.get("semantic", {}).items():
        phase11_runs[f"{name} Tester.test()"] = rec["test_launches"]
        phase11_runs[f"{name} training"] = rec["train"]["launches"]
        profiles[f"{name} training step"] = rec["train"]["profile"]
    if "processed_mind" in R:
        phase11_runs["processed MIND CLI"] = R["processed_mind"]["launches"]
    phase12_runs = {}
    p12 = R.get("phase12")
    if p12:
        phase12_runs["extractor (NAML)"] = p12["extractor"]["launches"]
        phase12_runs["splitter (bert-naml)"] = p12["splitter"]["launches"]
        for side in ("disk", "memory"):
            r = p12["splitter"][side]
            key = f"bert-naml Trainer, its cache from {side}"
            phase12_runs[f"{key} (init)"] = r["init"]["launches"]
            phase12_runs[f"{key} (step + dev)"] = r["train_launches"]
        phase12_runs["NAML with the embedded table Tester.test()"] = p12[
            "embed"]["launches"]
        for side in ("plain", "dp"):
            phase12_runs[f"NAML Trainer ({side}, batch {DP_BATCH})"] = p12[
                "dp"][side]["launches"]
    phase13_runs = {}
    for name, rec in (R.get("phase13") or {}).items():
        if not isinstance(rec, dict) or "ranks" not in rec:
            continue
        phase13_runs[f"{name} (one process)"] = rec["one"]["launches"]
        for r, rank in enumerate(rec["ranks"]):
            phase13_runs[f"{name} (rank {r} of 2, gloo)"] = rank["launches"]
    phase14_runs = {}
    p14 = R.get("phase14") or {}
    for name, rec in p14.items():
        if not isinstance(rec, dict) or "ranks" not in rec:
            continue
        phase14_runs[f"{name} (one process)"] = rec["one"]["launches"]
        for r, rank in enumerate(rec["ranks"]):
            phase14_runs[f"{name} (rank {r} of 2, gloo)"] = rank["launches"]
        for r, c in enumerate(rec.get("score_launches", [])):
            phase14_runs[f"{name} test pages (rank {r})"] = c
    if "llama slice" in p14:
        sl = p14["llama slice"]
        phase14_runs["llama slice (one process)"] = sl["one_launches"]
        for r, c in enumerate(sl["launches"]):
            phase14_runs[f"llama slice pp 2 (rank {r})"] = c
    phase15_runs = {}
    for name, rec in (R.get("phase15") or {}).items():
        if not isinstance(rec, dict) or "launches" not in rec:
            continue
        phase15_runs[f"{name} (one process)"] = rec["one_launches"]
        for r, c in enumerate(rec["launches"]):
            phase15_runs[f"{name} (rank {r} of {len(rec['launches'])}, "
                         f"gloo)"] = c
    runs.update(decoder_runs)
    runs.update(phase10_runs)
    runs.update(phase11_runs)
    runs.update(phase12_runs)
    runs.update(phase13_runs)
    runs.update(phase14_runs)
    runs.update(phase15_runs)
    phase16_runs = (R.get("phase16") or {}).get("launches", {})
    runs.update(phase16_runs)
    p16_checks = (R.get("phase16") or {}).get("checks", {})
    p16_pages = p16_checks.get("attention", [])

    def by_path(key):
        return {p: c.get(key, 0) for p, c in runs.items()}

    def profiled(key):
        return {p: pr["kernels"][key] for p, pr in profiles.items()}

    def of(key, res, **extra):
        src = "additive_pool" if key == "additive_pool" else "packed_attention"
        return {"name": key, "route": "cuda",
                "source": f"legommenders_tpu_torch/csrc/{src}.cu",
                "launches": sum(by_path(key).values()),
                "launches_by_path": by_path(key), **res,
                "main_path_ms": sum(v["ms"] for v in profiled(key).values()),
                "main_path_by_path": profiled(key), **extra}

    def shapes(checks):
        return {f"{c['pool']} {c['dtype']}": {k: c[k] for k in (
            "N", "L", "H", "kernel", "max_abs_err", "rel_err", "ms",
            "plain_ms", "bound_ms", "bound_by")} for c in checks}

    kernels = []
    checks = R.get("checks", [])
    pool_all = (checks + R.get("zoo_checks", []) + R.get("ctr_checks", [])
                + R.get("flatten_checks", []) + R.get("semantic_checks", []))
    pool_bf16 = [c for c in checks
                 if c["dtype"] == "bf16" and c["pool"] in POOLS]
    if not pool_bf16:
        pool_bf16 = [c for c in pool_all if c["dtype"] == "bf16"][:1]
    if pool_bf16:
        kernels.append(of("additive_pool", {
            "replaces": "legommenders_tpu/ops/pallas_additive.py:34",
            # item + user pool at NAML's full width, bf16 (the main dtype),
            # or the first pool shape of the phases that ran
            "max_abs_err": max(c["max_abs_err"] for c in pool_bf16),
            "ms": sum(c["ms"] for c in pool_bf16),
            "plain_ms": sum(c["plain_ms"] for c in pool_bf16),
            "bound_ms": sum(c["bound_ms"] for c in pool_bf16),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in pool_bf16) else "operations",
            "library_ms": None},
            pages={c["L"]: {k: c[k] for k in (
                "kernel", "max_abs_err", "rel_err", "ms", "plain_ms",
                "bound_ms", "bound_by")} for c in checks
                if c["dtype"] == "bf16" and c["pool"] not in POOLS},
            zoo_shapes=shapes(R.get("zoo_checks", [])),
            ctr_shapes=shapes(R.get("ctr_checks", [])),
            flatten_shapes=shapes(R.get("flatten_checks", [])),
            semantic_shapes=shapes(R.get("semantic_checks", [])),
            semantic_launches={name: {
                "test": rec["test_launches"]["additive_pool"],
                "pages": rec["pages"],
                "per_step": rec["train"]["launches_per_step"][
                    "additive_pool"]} for name, rec in R.get(
                "semantic", {}).items()},
            ctr_launches={name: {
                "test": rec["test_launches"]["additive_pool"],
                "per_step": rec["train"]["launches_per_step"][
                    "additive_pool"]} for name, rec in R.get("ctr", {})
                .items()},
            decoder_launches={p: c["additive_pool"]
                              for p, c in decoder_runs.items()},
            phase10_launches={p: c.get("additive_pool", 0)
                              for p, c in phase10_runs.items()},
            phase11_launches={p: c.get("additive_pool", 0)
                              for p, c in phase11_runs.items()},
            phase12_launches={p: c.get("additive_pool", 0)
                              for p, c in phase12_runs.items()},
            phase13_launches={p: c.get("additive_pool", 0)
                              for p, c in phase13_runs.items()},
            phase14_launches={p: c.get("additive_pool", 0)
                              for p, c in phase14_runs.items()},
            phase15_launches={p: c.get("additive_pool", 0)
                              for p, c in phase15_runs.items()},
            phase16_launches={p: c.get("additive_pool", 0)
                              for p, c in phase16_runs.items()},
            phase16_shapes=shapes(p16_checks.get("pools", [])),
            edge_checks=R.get("pool_edges"), checks=pool_all))
    sdpa = "torch.nn.functional.scaled_dot_product_attention"
    train = R.get("train_checks", [])
    tr = next((c for c in train if c["dtype"] == "bf16"
               and c["dropout"] == TRAIN_DROPOUT), None)
    tr0 = next((c for c in train if c["dtype"] == "bf16"
                and c["dropout"] == 0.0), None)
    dec = R.get("decoder_checks", {})
    dtrain = dec.get("llama training")
    fwd = bwd = None
    if tr is not None:
        fwd = {"max_abs_err": tr["out_max_abs_err"], "ms": tr["fwd_ms"],
               "plain_ms": tr["fwd_plain_ms"],
               "bound_ms": tr["fwd_bound_ms"],
               "bound_by": tr["fwd_bound_by"],
               "library_ms": tr["sdpa_fwd_ms"],
               "library": f"{sdpa} (forward, float mask, dropout_p)"}
        bwd = {"max_abs_err": max(tr[f"{g}_max_abs_err"]
                                  for g in ("dq", "dk", "dv")),
               "ms": tr["bwd_ms"], "plain_ms": tr["bwd_plain_ms"],
               "bound_ms": tr["bwd_bound_ms"],
               "bound_by": tr["bwd_bound_by"],
               # torch has no backward-only call: its forward + backward,
               # beside the port's forward + backward
               "library_ms": tr["sdpa_fwd_bwd_ms"],
               "library": f"{sdpa} (forward + backward, float mask, "
                          f"dropout_p)",
               "fwd_plus_bwd_ms": tr["fwd_ms"] + tr["bwd_ms"],
               "train_p0": {"ms": tr0["bwd_ms"]},
               # the f32 route (attention_bwd_tf32, 3xTF32): its bound at
               # 3xTF32's 165 TFLOP/s and on the CUDA cores, SDPA at f32
               "f32_training_page": {p: dict(
                   {k: c[k] for k in (
                       "bwd_ms", "bwd_bound_ms", "bwd_bound_by",
                       "bwd_cuda_core_bound_ms", "bound_peak",
                       "dq_max_abs_err", "dk_max_abs_err",
                       "dv_max_abs_err")},
                   fwd_plus_bwd_ms=c["fwd_ms"] + c["bwd_ms"],
                   library_ms=c["sdpa_fwd_bwd_ms"])
                   for p, c in ((c["dropout"], c) for c in train
                                if c["dtype"] == "f32")}}
    elif dtrain is not None:
        fwd = {"max_abs_err": dtrain["bf16_out_max_abs_err"],
               "ms": dtrain["ms"], "plain_ms": dtrain["plain_ms"],
               "bound_ms": dtrain["bound_ms"],
               "bound_by": dtrain["bound_by"],
               "library_ms": dtrain["library_ms"]}
        bwd = {"max_abs_err": max(dtrain[f"bf16_{g}_max_abs_err"]
                                  for g in ("dq", "dk", "dv")),
               "ms": dtrain["bwd_ms"], "plain_ms": dtrain["bwd_plain_ms"],
               "bound_ms": dtrain["bwd_bound_ms"],
               "bound_by": dtrain["bwd_bound_by"],
               "library_ms": dtrain["library_fwd_bwd_ms"]}
    decoder_launches = {}
    if fwd is not None:
        if tr0 is not None:
            fwd["train_p0"] = {"ms": tr0["fwd_ms"],
                               "library_ms": tr0["sdpa_fwd_ms"]}
        attn = next((c for c in R.get("attn_checks", [])
                     if c["dtype"] == "bf16"), None)
        if attn is not None:
            fwd["serving_page"] = {k: attn[k] for k in (
                "T", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "library_ms")}
        # the f32 route (attention_fwd_tf32, 3xTF32): its bound at 3xTF32's
        # 165 TFLOP/s and on the CUDA cores, SDPA at f32
        fwd["f32_training_page"] = {c["dropout"]: {
            "ms": c["fwd_ms"], "max_abs_err": c["out_max_abs_err"],
            "plain_ms": c["fwd_plain_ms"], "bound_ms": c["fwd_bound_ms"],
            "bound_by": c["fwd_bound_by"],
            "cuda_core_bound_ms": c["fwd_cuda_core_bound_ms"],
            "library_ms": c["sdpa_fwd_ms"]}
            for c in train if c["dtype"] == "f32"}
        attn32 = next((c for c in R.get("attn_checks", [])
                       if c["dtype"] == "f32"), None)
        if attn32 is not None:
            fwd["f32_serving_page"] = {k: attn32[k] for k in (
                "T", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "cuda_core_bound_ms", "library_ms")}
        kernels.append(of("packed_attention", dict(
            replaces="legommenders_tpu/ops/pallas_attention.py:53", **fwd),
            decoder_shapes={n: {k: c[k] for k in (
                "B", "T", "D", "heads", "bf16_out_max_abs_err",
                "bf16_out_rel_err", "f32_out_max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
                for n, c in dec.items()},
            decoder_launches={p: c["packed_attention"]
                              for p, c in decoder_runs.items()},
            phase10_launches={p: c.get("packed_attention", 0)
                              for p, c in phase10_runs.items()},
            phase11_launches={p: c.get("packed_attention", 0)
                              for p, c in phase11_runs.items()},
            phase12_launches={p: c.get("packed_attention", 0)
                              for p, c in phase12_runs.items()},
            phase13_launches={p: c.get("packed_attention", 0)
                              for p, c in phase13_runs.items()},
            phase14_launches={p: c.get("packed_attention", 0)
                              for p, c in phase14_runs.items()},
            phase15_launches={p: c.get("packed_attention", 0)
                              for p, c in phase15_runs.items()},
            phase16_launches={p: c.get("packed_attention", 0)
                              for p, c in phase16_runs.items()},
            phase16_dh8_pages=[{k: c[k] for k in (
                "page", "B", "T", "out_max_abs_err")} for c in p16_pages],
            checks=R.get("attn_checks", [])))
        decoder_launches = {p: c["packed_attention_backward"]
                            for p, c in decoder_runs.items()}
        kernels.append(of("packed_attention_backward", dict(
            replaces="legommenders_tpu/ops/pallas_attention.py:84", **bwd),
            decoder_shapes={n: {
                "B": c["B"], "T": c["T"], "D": c["D"], "heads": c["heads"],
                "bf16_max_abs_err": max(c[f"bf16_{g}_max_abs_err"]
                                        for g in ("dq", "dk", "dv")),
                "f32_max_abs_err": max(c[f"f32_{g}_max_abs_err"]
                                       for g in ("dq", "dk", "dv")),
                "ms": c["bwd_ms"], "plain_ms": c["bwd_plain_ms"],
                "bound_ms": c["bwd_bound_ms"],
                "bound_by": c["bwd_bound_by"],
                "library_ms": c["library_fwd_bwd_ms"],
                "fwd_plus_bwd_ms": c["ms"] + c["bwd_ms"],
                "f32_fwd_ms": c["f32_ms"],
                "f32_fwd_bound_ms": c["f32_bound_ms"],
                "f32_ms": c["f32_bwd_ms"],
                "f32_bound_ms": c["f32_bwd_bound_ms"],
                "f32_bound_by": c["f32_bwd_bound_by"],
                "f32_cuda_core_bound_ms": c["f32_bwd_cuda_core_bound_ms"],
                "f32_library_fwd_bwd_ms": c["f32_library_fwd_bwd_ms"]}
                for n, c in dec.items() if "bwd_ms" in c},
            decoder_launches=decoder_launches,
            phase10_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase10_runs.items()},
            phase11_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase11_runs.items()},
            phase12_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase12_runs.items()},
            phase13_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase13_runs.items()},
            phase14_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase14_runs.items()},
            phase15_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase15_runs.items()},
            phase16_launches={p: c.get("packed_attention_backward", 0)
                              for p, c in phase16_runs.items()},
            phase16_dh8_pages=[{k: c[k] for k in (
                "page", "B", "T", "grad_max_abs_err")} for c in p16_pages],
            f32_dh128_edges=R.get("f32_edges", []),
            checks=train))
    if tr is not None:
        kernels.append(of("dropout_keep_mask", {
            "replaces": "legommenders_tpu/ops/pallas_attention.py:272",
            # as in JAX, the mask is drawn only to hold the forward and the
            # backward against their plain versions: no main path launches
            # it
            "on_main_path": False,
            "max_abs_err": 0.0 if tr["mask_equals_plain"] else 1.0,
            "ms": tr["mask_ms"], "plain_ms": tr["mask_plain_ms"],
            "bound_ms": tr["mask_bound_ms"],
            "bound_by": tr["mask_bound_by"], "library_ms": None}))
    return kernels


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phases = parse_phases(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails outside a checkout, before any output: the port is part of the
    # repository
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.ops import build

    t_run = time.perf_counter()
    with phase_timer(1, "device"):
        device = torch.device("cuda", 0)
        card = card_line()
        log(f"[device] {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; phases {sorted(phases)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with phase_timer(2, "build"):
        t0 = time.perf_counter()
        texts = build.build_all(["additive_pool", "packed_attention"])
        log(f"[build] additive_pool + packed_attention, one nvcc each at "
            f"once, in {time.perf_counter() - t0:.2f} s")
        for name, text in texts.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")

    R = {}
    if 3 in phases:
        with phase_timer(3, PHASES[3]):
            R.update(run_kernel_checks(device))
    with phase_timer("data", "host data build"):
        data = SyntheticProcessor(**DATA_KW).as_lego_data()
    if 4 in phases:
        with phase_timer(4, PHASES[4]):
            R.update(run_serving(data, device))
    if 5 in phases:
        with phase_timer(5, PHASES[5]):
            R.update(run_training(data, device, card))
    if 6 in phases:
        with phase_timer(6, PHASES[6]):
            R.update(run_loop(data, device, card))
    if 7 in phases:
        with phase_timer(7, PHASES[7]):
            R.update(run_news_zoo(data, device, card))
    if 8 in phases:
        with phase_timer(8, PHASES[8]):
            R.update(run_ctr_zoo(data, device, card))
    if 9 in phases:
        with phase_timer(9, PHASES[9]):
            R.update(run_decoders(data, device, card))
    if 10 in phases:
        with phase_timer(10, PHASES[10]):
            R.update(run_phase10(data, device, card))
    if 11 in phases:
        with phase_timer(11, PHASES[11]):
            R.update(run_phase11(data, device, card))
    if 12 in phases:
        with phase_timer(12, PHASES[12]):
            R.update(run_phase12(data, device, card))
    if 13 in phases:
        with phase_timer(13, PHASES[13]):
            R.update(run_phase13(device, card))
    if 14 in phases:
        with phase_timer(14, PHASES[14]):
            R.update(run_phase14(device, card))
    if 15 in phases:
        with phase_timer(15, PHASES[15]):
            R.update(run_phase15(device, card))
    if 16 in phases:
        with phase_timer(16, PHASES[16]):
            R.update(run_phase16(data, device, card))

    kernels = _kernel_line(R)
    total = time.perf_counter() - t_run
    log(f"[phase] all: {total:.2f} s; by phase "
        f"{json.dumps({k: round(v, 2) for k, v in TIMES.items()})}; "
        f"outside the phases {total - sum(TIMES.values()):.2f} s; profiler "
        f"summaries {PROFILE_SUMMARY_S[0]:.2f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
