#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository around this file.  Phases, each of which exits non-zero on
failure:

  1. build   — compile every kernel under src/repro_torch/csrc with nvcc,
               one process per source, in parallel;
  2. kernels — each kernel's wrapper on card tensors at the serving path's
               shapes (masked_matmul at decode M = 4, prompt M = 32 and
               prefill M = 4096, each row printed with its route: the skinny
               kernel for M <= 32, bit-equal there to the tile kernel forced
               on the same operands; the tile kernel's occupancy pre-pass
               too, and once on block-pruned operands), held against its
               plain PyTorch version (tolerances below), then timed beside
               the plain version, the one PyTorch call computing the same
               function (where there is one) and the H100's bound for the
               same work;
  2c. mask_pack — both kernels bit-equal to the plain version on bf16, fp16
               and fp32 with +-0.0, NaN, +-inf and subnormals (the planner's
               route on every case, the lane route forced on stream-shaped
               ones, a misaligned view on the lane route); the prompt-32
               decode leaf, the 4096-token decode leaf and its install row,
               each route as a call and on device time with L2 flushed,
               beside the plain version and the bound; the launch floor (a
               one-word call's device time) and the host time of a call at
               the decode leaf, split into its parts;
  3. serve   — full-width llama3.2-1b, quant_sparse, random weights from a
               seed, 4 slots, 6 requests, prompt 32, gen 16, through
               ``repro_torch.launch.serve.serve_session`` on the card; the
               kernels' launch counters are zeroed just before and read just
               after, and every kernel must have launched; every product
               there has M <= 32, so tile_occupancy must not launch;
  3b. profile — a second engine over the same model, four decode ticks
               under torch.profiler: the device-busy share and the kernels
               by device time per tick; each tick launches the skinny
               kernel 7 times per layer, mask_pack twice and tile_occupancy
               never;
  3c. spec   — the example spec examples/specs/serve_quant_sparse.json run
               by the port's launcher as a subprocess, as a user would:
               ``python -m repro_torch.launch.serve --spec ... --set
               arch.reduced=false --set kernels.policy=auto --set
               shape.prompt_len=64 --json ...`` (full-width llama3.2-1b, 2
               slots, 6 requests, gen 24; prompt 64 so that prefill takes
               the tile kernel).  It must exit 0 with the spec_hash of the
               in-process build_spec of the same layers; an in-process
               ServeSession over that spec, counters zeroed just before and
               read just after, must give the same tokens and launch the
               skinny and tile kernels, tile_occupancy, mask_pack and
               flash_attention; a run with serving.snapshot_every=3, then
               one with serving.restore_path, drains the same tokens, and so
               does serving.pages=true; kernels.policy=ref must exit
               non-zero with the SpecError.  Printed: the launcher's prefill
               s per request, tokens/s and wall time.  Then each kernel of
               the path against its plain version at the path's shapes
               (decode M 2, prefill M 64 and the lm_head, flash_attention at
               S 64, kv_pack on the pool's leaf and pages), as 6i does: the
               spec's 2 slots and 64-token prompts are not phase 2's shapes;
  4. check  — the reduced llama3.2-1b on the card against the same model on
               the CPU (plain versions), prefill and decode logits;
  5a. stochastic_round — bit-equal to its plain version on the reference's
               example shapes and a 32x224x224x64 activation, timed;
  5b. backward — masked_matmul_dx / _dw at VGG-19's c0_1, c3_0 and fc6
               backward shapes at batch 32 against the plain fp32 product
               (within 2K 2^-24 (|a|@|b|)), bit-identical across two calls,
               timed beside torch.matmul; exact on {0, 2^-8} operands at
               c0_1; a block-pruned case whose skip flags equal the plain
               version's; split-K forward with SR and the split-K reduce,
               exact (the reduce also at N = 50 from an unaligned base),
               the reduce timed as a call and on device time with L2
               flushed, each beside torch.sum's;
  5c. train  — full-width VGG-19 at 224x224, batch 32, quant_sparse with SR,
               the sparse backward and the memstash stash policy, sgdm with
               Q4.16 SR weights, 3 steps through
               ``repro_torch.launch.train.run_arm``; counters zeroed just before
               and read just after; every loss finite, every parameter on the
               grid after each step, every training kernel launched; s/step,
               images/s, peak memory, activation density and tile skip; then
               one step under torch.profiler;
  5d. check  — tiny_cnn, one nearest-rounding step on the card against the CPU;
  5e. arms   — the example's fp32 / SR / nearest arms on tiny_cnn, 150 steps,
               gaps printed (not gated);
  5f. train LM — examples/specs/train_quant_sparse.json at full width
               (llama3.2-1b, batch 8, seq 128, quant_sparse, SR, Q4.16 SR
               weights, AdamW with warmup, the sparse backward) through
               ``python -m repro_torch.launch.train --spec ... --set
               arch.reduced=false --set train.steps=6 --set
               train.ckpt_dir=`` as a subprocess: exit 0, the reference's
               last line with the spec_hash of the in-process build, finite
               losses; the same spec in process with telemetry on (s/step
               from its train.step spans, tokens/s, peak memory, every
               parameter on the grid), then one step at batch 1 / seq 32 (the
               skinny kernel) and one at seq 1040 (dW's K over 8192: split-K
               and its reduce), counters zeroed just before the first run
               and read just after the last: the tile and skinny kernels,
               tile_occupancy, dx, dw, splitk_reduce and stochastic_round
               must launch, flash_attention must not; one step profiled;
               each path kernel against its plain version at the path's
               shapes; at reduced size the reference's SR-vs-fp32 claim
               (60 steps, its two bounds) and its resume contract (30
               straight against 20 + a resume to 30, rtol 1e-4);
  5g. train archs — the rest of LM training at every width, batch 8, seq
               128, the example train spec's numerics (quant_sparse, SR,
               Q4.16 SR weights, AdamW, the sparse backward), random weights
               from seed 0: mamba2-780m whole from the example spec in
               process (s/step from its train.step spans, peak, every
               parameter on the grid; its launcher run went for 8i's time:
               5f runs that launcher); olmoe-1b-7b (and once more with
               memstash.policy=stash: the stashed unit's aux loss),
               deepseek-v2-lite-16b and recurrentgemma-9b cut to
               TRAIN_ARCHS_UNITS units, 3 steps each, whisper-medium whole
               with its frames and internvl2-26b cut, with its image
               prefix, 2 steps each, all in process through
               make_train_step (the frames / img_embeds branches): finite
               losses, every parameter on the grid, s/step, tokens/s, peak
               and at least TRAIN_ARCHS_HEADROOM of the card free at it, one
               step profiled, the MoE archs' dropped share and aux loss
               after training; counters zeroed just before the first run
               and read just after the last: each part launches the tile
               kernel, tile_occupancy, dx, dw and stochastic_round,
               splitk_reduce exactly where a product's K passes 8192,
               ssd_scan on mamba2 (through its autograd wrapper),
               flash_attention never; each part's path kernels against
               their plain versions at its shapes (mamba2's autograd
               wrapper's gradients against autograd through the chunked
               form, on the card); each reduced arch on the card against
               the CPU (loss and every gradient, nearest rounding on Q16.60);
  5h. prune_stash — (run last, after 7c) magnitude pruning and the lossy
               stash at full width,
               random weights from seed 0: llama3.2-1b trained with
               StepConfig(prune_ratio=0.5) and the example train spec's
               numerics (batch 8, seq 128) through make_train_step, 3 steps
               and a profiled fourth (losses finite, on the grid, each
               pruned projection's zero share within 0.02 of 0.5, the tile
               kernel, tile_occupancy, dx, dw and stochastic_round
               launched; the measured forward / dX / dW tile-skip shares);
               the same model with eager pruning (apply_pruning after each
               of 4 updates, PruneSchedule(0.5, 0, 2)): the measured
               sparsity in (0.4, 0.6), the 262.7 M-element embedding's
               threshold its s-quantile, ms per apply_pruning call; phase
               3's traffic on ServingEngine(prune_ratio=0.5) (every request
               done, finite, the skinny kernel, mask_pack and
               flash_attention launched; tokens/s and a profiled tick beside
               3b's); the reduced model's tokens card vs CPU; VGG-19 at 224²,
               batch 32, SR, through run_arm with every stash point at
               capacity 0.6 (losses finite, on the grid; one more step at
               capacity 1.0 and 0.6 with autograd's saved storages counted,
               the value buffers and overflow per point; a capacity-1.0
               record bit-equal to the exact one) and measure_cnn_stash at
               both capacities; counters zeroed just before each run and
               read just after; each path kernel against its plain version
               with the weights pruned as the path prunes them;
  6a. flash_attention — the kernel against its plain version on the
               reference registry's five examples (fp32 atol 2e-5, bf16 2e-2),
               a non-causal ragged case, and llama3.2-1b's prefill shapes at
               S 32 / 128 / 512 / 4096 / 8192 and a D 128 row at S 4096 (q/k/v
               as the model passes them), each with the query tile it took,
               timed as a call, on device time with L2 flushed and on host
               time, beside the plain version, fp32
               scaled_dot_product_attention and the bound;
  6b. ssd_scan — y and the final state against the chunked plain version
               (rel 1e-4) on the registry's three examples and at mamba2-780m's
               prefill shape (x (1, 2000, 48, 64), b/c (1, 2000, 1, 128), read as
               views of one projection as the model does), also at the model's
               decays; each of the four stage kernels against its plain stage
               (rel 1e-4); timed as a call, and each stage and the total on
               device time with L2 flushed; the kernel's and
               the chunked plain version's deviation from a float64 run of the
               sequential oracle, printed (not gated);
  6c. serve_long — full-width llama3.2-1b, quant_sparse, 4 slots, 4 requests,
               prompt 4096, gen 16, counters zeroed just before and read just
               after: flash_attention, masked_matmul, tile_occupancy and
               mask_pack must launch; prefill s per request, tokens/s, peak
               memory; then three of its decode ticks profiled as in 3b;
  6d. serve_mamba2 — full-width mamba2-780m, quant_sparse, 4 slots, 6
               requests, prompt 2000, gen 16: ssd_scan, masked_matmul and
               tile_occupancy must launch; two more requests with
               deadline_ticks=0 queue behind the full pool and must be shed
               with "deadline" and no tokens;
  6e. check  — the reduced mamba2-780m and llama3.2-1b on the card against the
               CPU at a 300-token prompt, prefill and decode logits (atol 1e-3);
  6f. profile — one 4096-token llama3.2-1b prefill and one 2000-token
               mamba2-780m prefill under torch.profiler: device time by kernel;
  6g. survive — full-width llama3.2-1b, quant_sparse, 4 slots, 8 requests,
               prompt 512, gen 16, greedy: the uninterrupted run (the oracle),
               then the same requests through ChaosHarness (an .npz round
               trip, a rescale to 2 slots that spills, a snapshot, a rescale
               back to 4, a rewind, a kill into a fresh engine over the same
               parameter tensors): every request's tokens must equal the
               oracle's and requests must have spilled and resumed; an
               explicit .npz round trip timed (bytes, save and load s);
               slots 0-1's decode logits at 4 and at 2 slots must be
               bit-equal; one _spill_slot and one _resume_one timed, the
               payload's and the pool's bytes; sampled decode (4 requests)
               twice and through a snapshot and a rewind, equal; the
               oracle's workload with telemetry on: span count, tokens/s,
               equal tokens; then full-width mamba2-780m (6 requests, prompt
               256) through rescale 4 -> 2 -> 4, a snapshot and a rewind in
               memory, with the same gates; counters zeroed just before
               each model's chaos run and read just after: the skinny and
               tile kernels and tile_occupancy (both models),
               flash_attention and mask_pack (llama) and ssd_scan (mamba2)
               must launch there;
  6h. paged  — full-width llama3.2-1b, quant_sparse, on the paged
               copy-on-write pool (``serving/paging``): 4 slots, 8 requests
               of 500-512 tokens whose first 256 are one system prompt, gen
               16, 8 tokens a page, max_len 530 (not a multiple of the
               page), 8 page installs a tick.  The uninterrupted paged run
               (counters zeroed just before, read just after: the skinny and
               tile kernels, flash_attention and mask_pack must launch),
               the same requests on the monolithic engine (tokens must be
               equal), a chaos run (an .npz round trip, the page budget cut
               to two requests' worth with spills, a snapshot, a rewind, the
               budget raised back; tokens equal to the uninterrupted run's,
               requests spilled and resumed); a prefix hit must happen.
               Printed: tokens/s of both engines, a decode tick's wall and
               device ms with its launches (mask_pack twice), page-array
               bytes, peak page utilization, the most frames shared, an
               .npz round trip's bytes and save / load s, a request's spill
               and resume ms;
  6i. archs  — full-width minitron-4b and mistral-nemo-12b (head_dim 128;
               GQA groups of 3 and 4), quant_sparse, 4 requests of prompt
               512, gen 16, 4 slots, on the paged and then the monolithic
               engine over the same parameters: tokens equal, logits
               finite, and in the paged run the skinny and tile kernels,
               tile_occupancy, splitk_reduce (d_ff over 8192),
               flash_attention at D 128 and mask_pack launched; prefill s
               per request, tokens/s, peak memory; after each model, every
               kernel of its path at the full-width shapes the path gives
               it against its plain version (flash_attention at D 128 and
               the model's group, masked_matmul on every projection at M
               512 and 4 with the occupancy flags exact, splitk_reduce and
               kv_pack bit-equal; the tile kernel once more at the
               lm_head's K x N, up to 786 M); then each reduced model on
               the card against the CPU as in 6e;
  6j. hybrid — full-width recurrentgemma-9b (38 layers: 12 x (rglru, rglru,
               local) + 2 rglru; local attention D 256, 16 heads on one kv
               head, window 2048), quant_sparse, random weights from seed
               0, 4 requests of prompt 2600 (past the window, not a multiple
               of a tile), gen 16, 4 slots, on the monolithic engine: the
               counters zeroed just before run() and read just after (the
               skinny and tile kernels, tile_occupancy, splitk_reduce,
               mask_pack and flash_attention at D 256 launched), finite
               logits, prefill s per request, tokens/s, peak memory under
               80 GB; a second engine over the same parameters: decode
               logits of slots 0-1 at 4 and at 2 slots bit-equal, three
               profiled decode ticks (wall against device ms), the same
               tokens; the paged engine refused (no pageable leaf); every
               path kernel against its plain version at the path's shapes
               (flash_attention at D 256, window 2048, S 2600; masked_matmul
               on every projection, the RG-LRU's included, at M 2600 and 4;
               kv_pack on the ring leaf), the D 256 kernel timed at S 4096
               beside its plain version, fp32 SDPA and its bound; then
               full-width qwen2-7b with random non-zero qkv biases as 6i's
               archs (paged tokens = monolithic tokens); each reduced model
               on the card against the CPU;
  6k. moe    — full-width olmoe-1b-7b (16 x (attn, moe): 64 experts top-8,
               MHA D 128) and deepseek-v2-lite-16b (an MLA layer with a
               dense SwiGLU, then 26 x (mla, moe): 64 routed experts top-6
               and 2 shared), quant_sparse, random weights from seed 0, 4
               requests of prompt 512, gen 4 (16 before 5h, 8 before 8), 4 slots, max_len 530, on the
               monolithic and then the paged engine (page 8, whole-prompt
               installs) over the same parameters: counters zeroed just before each run() and read
               just after (every kernel of the path launched; deepseek's
               MLA prefill runs the chunked attention, so flash_attention
               launches 0 times there), paged tokens = monolithic tokens;
               a third engine admits the four at once: decode logits of
               slots 0-1 at 4 and 2 slots bit-equal, one profiled decode
               tick (three before 8), then one decode tick (where none may drop) and one
               request's prefill under moe.record_routing (tokens per
               expert, assignments dropped, dispatch rows left zero, the
               experts' skipped tile steps); peak memory; every path kernel at the
               path's shapes (the experts' products at M 4 and at the
               prefill capacity 80 / 60, flash_attention at D 128 with 16
               heads on 16 kv heads, kv_pack and mask_pack's route on the
               k/v, ckv and krope leaves); each reduced model on the card
               against the CPU;
  6l. slice15 — full-width whisper-medium (24 + 24 layers, d 1024, 16
               heads, enc_seq 1500), quant_sparse, from a spec through the
               launcher as a subprocess (``--set arch.id=whisper-medium
               --set arch.reduced=false ...``; batch 4, prompt 16, gen 16, the
               static path, whose encoder and cross-K/V run dense as in the
               reference), then an in-process ServeSession over the same
               spec (counters zeroed just before, read just after: the
               skinny kernel launched; tokens equal the launcher's);
               internvl2-26b at every width and 45 of its 48 layers (all 48
               do not fit the card beside a decode tick's repack), 4
               requests of 512 text tokens behind the 256-position image
               prefix, gen 16, 4 slots, monolithic then paged (whole-prompt
               installs): every path kernel launched in each (flash_attention
               at a GQA group of 6, 2 heads a tile; mask_pack on the pool's
               leaves; splitk_reduce for d_ff 16384), paged tokens =
               monolithic tokens, decode logits at 4 and 2 slots bit-equal,
               three profiled ticks, at least 3 GiB of the card free at the
               peak; llama3.2-1b's int8 KV cache on the static path (4 x 512,
               gen 16): tokens agreeing with the bf16 cache's, the caches'
               bytes, the path kernels launched; every path kernel against
               its plain version at those shapes (whisper's products at M 4
               and at the encoder's M 6000, internvl2's at M 768 and 4 and
               its lm_head, flash at S 768, kv_pack on its leaves; llama's at
               M 512); the reduced whisper-medium, internvl2-26b and the int8
               static path on the card against the CPU;
  7a. dangling_filter — bit-equal to its plain version on the registry's
               examples, -0.0 / NaN / inf entries at a length with a scalar
               tail, unaligned views, bf16 and 32x224x224x64 fp32; timed there
               beside the plain version and the bound;
  7b. sweep  — ``repro_torch.benchmarks.bench_kernels.smoke_rows`` on the card:
               every op's kernel against its plain version on the reference's
               examples under the op's compare; counters zeroed just before and
               read just after, every kernel of the sweep must launch;
  7c. paper  — ``sparsity_probe(density=0.5, size=512)`` on the card's kernels,
               then Table 1 and the Figs. 11-16 geomeans of the model with and
               without the measured tile-skip fractions, beside the paper's;
  8. mesh   — (run last) the port's mesh: one process per rank, joined by
               ``repro_torch.dist.launch`` in a gloo group, every rank on this
               one card (NCCL refuses two ranks on one device), card tensors
               staged through host memory for each hop; the kernels are built
               before any rank starts.  The unsharded runs first, in this
               process; then four ranks: (a) packed_all_gather in collective
               mode equal to simulation mode bit for bit on 2**26 elements a
               rank (fp32 at densities 1.0, 0.5 and 0.1, bf16 at 0.5; a
               reduce-scatter too), mask_pack on each rank's payload equal to
               its plain version, the wire bytes and compression against fp32;
               (c) full-width llama3.2-1b on the static path, quant_sparse,
               batch 8 (2 rows a rank), prompt 32, gen 16, at
               shape.mesh.data=4: tokens equal to the unsharded run's, the
               skinny and tile kernels, tile_occupancy and mask_pack launched
               on every rank; (d) pipeline_apply over 4 stages and 6
               microbatches of 64 rows, each stage one llama3.2-1b MLP's two
               products through spring_matmul, within 2b's bound of the stages
               in sequence.  Then two ranks: (b) the example train spec at full
               width, batch 8, seq 128, 1 step at shape.mesh.data=2 (two
               replicas: four do not fit the card): the loss and every
               trained parameter (a checksum of every leaf's bits)
               bit-equal to the unsharded run's, on the grid, the probe exact,
               the tile kernel, tile_occupancy, stochastic_round and mask_pack
               launched on every rank; then a step at pod=2 with
               compress_pod_grads (4 rows a pod): losses finite, on the grid,
               each rank's EF buffers exactly local - dequant and within one
               int8 step of its gradient on every element (so the exchanged
               mean is within one step of the pods' true mean), and the
               exchange's mean against the true mean measured on the first
               2**20 elements of every leaf; both pods' parameters bit-equal
               after the step (a checksum of every leaf's bits, gathered).
               Printed: the backend, each rank's peak, wall time and staged
               hops, prefill s and tokens/s of both serving runs.  Then four
               ranks at shape.mesh.model=4, llama3.2-1b's weights split over
               them: (e) the example train spec, nearest rounding, losses
               within rel 1e-4 of the unsharded run's; (f) the static path,
               tokens equal to the unsharded run's but for a printed near
               tie; (g) the engines on phase 3's traffic at gen 8,
               monolithic (a snapshot mid-run, restored by an unsharded
               engine here), paged with a shared system prompt and pruned at
               0.5 through the ServeSession: tokens under the same rule,
               each rank's pool two of the eight kv heads, prefill s,
               tokens/s, ticks and model hops a tick; (h) expert
               parallelism, llama3.2-1b's shards freed first: full-width
               olmoe-1b-7b (16 of 64 experts and 4 of 16 kv heads a rank)
               and deepseek-v2-lite-16b (16 of 64 routed experts, 4 of 16
               MLA heads, its latent pool whole) drawn leaf by leaf and
               served on 6k's traffic through the monolithic engine, tokens
               equal to 6k's unsharded tokens but for a printed near tie
               at the first differing step (the first layer routing the
               request's rows otherwise, each row's unsharded k-th and
               (k+1)-th router probabilities within 1e-5; or, where none
               is, the token's top-2 logit gap below the arch's own
               first-step logit difference), >= 4 GiB of the card free at
               the ranks' peak; olmoe-1b-7b trained from the example spec
               (nearest, batch 8, seq 128, 2 steps) at 4 of 16 layers:
               losses within rel 1e-4 of the unsharded run's here and
               bit-equal across ranks, the routers and norms the same bits
               on every rank, each rank's parameter bytes its shards'; every
               path kernel on every rank and at the shard shapes against its
               plain version; (i) the SSM and RG-LRU blocks, 8h's runs freed
               first: full-width mamba2-780m (12 of 48 SSM heads a rank,
               in_proj's output gathered whole, its conv state whole) and
               recurrentgemma-9b (1,024 of 4,096 RG-LRU channels, 4 of 16
               local heads on the one kv head) drawn leaf by leaf and served
               on the monolithic engine at 4 x 512, gen 8, 4 slots, tokens
               equal to the same runs unsharded here but for a printed near
               tie (the token's top-2 logit gap below the arch's own
               first-step logit difference, itself within 1e-3), each
               rank's parameter and pool bytes its shards'; mamba2 trained
               whole and recurrentgemma at 1 unit + its 2 suffix layers from
               the example spec (nearest, batch 8, seq 128, 2 steps):
               losses within rel 1e-4 of their unsharded runs here and
               bit-equal across ranks, the whole leaves (conv weights,
               a_log, lam, norms) the same bits on every rank; every path
               kernel on every rank and at the shard shapes against its
               plain version.

Then it prints one ``{"kernels": [...]}`` line, the card's name and power
limit from nvidia-smi, and, last, the ``{"ok": true, "device": ...}`` line.
TF32 is off throughout: Q4.16 values carry 21 significant bits, TF32 keeps
11.  The full report is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and fp32 on the
# CUDA cores (the kernels use no tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# llama3.2-1b projections, (K, N) in the reference's (d_in, d_out) layout
LAYER_SHAPES = {"q": (2048, 2048), "k": (2048, 512), "v": (2048, 512),
                "o": (2048, 2048), "gate": (2048, 8192), "up": (2048, 8192),
                "down": (8192, 2048)}
DECODE_M, PREFILL_M = 4, 32
SLOTS, REQUESTS, PROMPT, GEN = 4, 6, 32, 16


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def timed(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: bytes read ahead of each call that :func:`cold_device_ms` times: ten
#: times the H100's 50 MB L2, so none of the call's operands is left there,
#: and about 0.17 ms of the card's time, in which the host queues the call
L2_FLUSH_BYTES = 512 * 2**20


def cold_device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of one call of ``fn`` with its operands out of L2:
    CUDA events just around each call, each call queued behind a read of
    :data:`L2_FLUSH_BYTES`.  A read leaves L2 holding clean lines, so the
    call pays no write-back of the flush's own data.  The card is still
    reading while the host queues the call, so the events time the call's
    kernels and not its host time.  :func:`timed` times a loop of calls
    instead, which the host paces when a call is shorter than its host
    time and which finds a repeated call's operands in L2."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.amax()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def host_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean host ms per call of ``fn``: the wall time of ``iters`` calls
    queued without a wait (the card runs each in less time than the host
    takes to queue it, so the host never waits on a full queue)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall * 1e3 / iters


def device_time_by_kernel(prof, per: int = 1) -> list:
    """(name, device ms, calls) of the device-side events of a profile,
    divided by ``per``, busiest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels'
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3 / per, ev.count // per))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_decode(dev, prompt: int = PROMPT, ticks: int = 4, prune_ratio: float = 0.0) -> dict:
    """Where a decode tick's time goes: a full-width llama3.2-1b engine of
    SLOTS slots with ``prompt``-token requests, all slots admitted first,
    then ``ticks`` pooled decode ticks under torch.profiler.  Prints the
    wall time per tick, the device-busy share of the window, the kernels by
    device time and the launches per tick: the skinny kernel 7 per layer,
    tile_occupancy never, mask_pack twice (the pool's k and v leaves).
    ``prune_ratio``: the engine prunes every dense projection's weight at
    each call (``ServingEngine(prune_ratio=...)``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.launch.serve import serving_config
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch("llama3.2-1b").resolve(False)
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=SLOTS,
                        max_len=prompt + GEN + 1, seed=0, device=dev, prune_ratio=prune_ratio)
    for p in synthetic_prompts(SLOTS, SLOTS, prompt, cfg.vocab, 0):
        eng.submit_prompt(p, GEN)
    eng.step()  # admissions (prefill + install) and the first decode tick
    eng.step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    del eng
    per_tick = {k: v / ticks for k, v in kernels.launch_counts().items() if v}
    tag = f"profile prompt {prompt}" + (f" pruned {prune_ratio}" if prune_ratio else "")
    print(f"[{tag}] launches per decode tick {per_tick}", flush=True)
    if per_tick.get("masked_matmul_skinny") != 7 * cfg.n_layers or "tile_occupancy" in per_tick \
            or per_tick.get("mask_pack") != 2:
        fail(f"a decode tick must launch the skinny kernel {7 * cfg.n_layers} times, "
             f"mask_pack twice and tile_occupancy never: {per_tick}")
    rows = device_time_by_kernel(prof, ticks)
    busy_ms = sum(r[1] for r in rows)
    tick_ms = wall_ms / ticks
    if busy_ms == 0:
        print(f"[{tag}] decode tick {tick_ms:.2f} ms wall; device time not measured "
              f"(the profiler recorded no device activity)", flush=True)
    else:
        print(f"[{tag}] decode tick {tick_ms:.2f} ms wall (profiled), device busy "
              f"{busy_ms:.2f} ms = {busy_ms / tick_ms:.1%}; top kernels per tick:", flush=True)
        for name, ms, n in rows[:12]:
            print(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:90]}", flush=True)
    return {"prompt": prompt, "prune_ratio": prune_ratio, "tick_ms": tick_ms,
            "device_busy_ms": busy_ms,
            "launches_per_tick": per_tick,
            "kernels": [{"name": n, "ms_per_tick": ms, "calls_per_tick": c}
                        for n, ms, c in rows[:40]]}


# -- 2c. mask_pack ----------------------------------------------------------------

#: one (layer, slot) k/v block of llama3.2-1b's pool is max_len x 8 kv heads
#: x 64 values, max_len = prompt + GEN + 1
KV_ROW = 8 * 64
#: exactness cases (n_blocks, block_len): the prompt-32 pool's decode and
#: install leaves, ragged lengths, a sweep-like 1-D length, one word, a
#: partial last warp step
MP_CASES = ((64, (PROMPT + GEN + 1) * KV_ROW), (16, (PROMPT + GEN + 1) * KV_ROW), (7, 1000),
            (3, 33), (1, 4096), (1, 32), (5, 288))


def _pack_operand(n_blocks: int, block_len: int, dtype, g):
    """Values with 40% zeros, every 7th -0.0, and +-0.0, NaN, +-inf and
    +-subnormals of ``dtype`` at one place in 16, made on the card from
    the generator ``g``."""
    import torch

    dev = g.device
    x = torch.randn(n_blocks, block_len, generator=g, device=dev)
    x *= torch.rand(n_blocks, block_len, generator=g, device=dev) > 0.4
    x[:, ::7] = -0.0
    sub = torch.finfo(dtype).smallest_normal / 4
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), float("-inf"), sub, -sub],
                            device=dev)
    flat = x.view(-1)
    at = torch.randint(0, flat.numel(), (max(1, flat.numel() // 16),), generator=g, device=dev)
    flat[at] = specials[torch.randint(0, len(specials), at.shape, generator=g, device=dev)]
    return x.to(dtype)


def phase_mask_pack(dev) -> dict:
    """(2c) both kernels of ``mask_pack`` against its plain version, exact,
    on bf16 / fp16 / fp32 with special values: the planner's route on every
    case, the lane route forced on stream-shaped ones, and a misaligned
    view (which must take the lane route); then the timed rows: the
    prompt-32 decode leaf, the 4096-token decode leaf and its install row,
    each route as a call and on device time with L2 flushed, beside the
    plain version and the bound; the launch floor (a one-word call's device
    time); the host time of one call at the decode leaf, split into its
    parts."""
    import math

    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.mask_compress import ops as mc

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(2)
    n_sms = cuda.sm_count(dev.index)
    err = 0  # max |kernel - plain| over the words, as unsigned integers
    n_checked = 0

    def check(x, route, tag):
        nonlocal err, n_checked
        got, want = mc._launch(x, route=route), mc.mask_pack_reference(x)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"mask_pack {tag}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
        words = [w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF for w in (got, want)]
        e = int((words[0] - words[1]).abs().max()) if got.numel() else 0
        if e:
            fail(f"mask_pack {tag} route={route} disagrees with its plain version")
        err = max(err, e)
        n_checked += 1

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        elem = mc._ELEM_BYTES[dtype]
        for n_blocks, blen in MP_CASES:
            x = _pack_operand(n_blocks, blen, dtype, g)
            check(x, None, f"{dtype} ({n_blocks},{blen})")
            if mc.plan(n_blocks, blen, elem, True, n_sms).route == "stream":
                check(x, "lane", f"{dtype} ({n_blocks},{blen})")
        base = _pack_operand(1, 6 * 1024 + 1, dtype, g)
        view = base.view(-1)[1:].view(6, 1024)  # contiguous, off 16-byte alignment
        if mc.plan(6, 1024, elem, view.data_ptr() % 16 == 0, n_sms).route != "lane":
            fail("mask_pack: a misaligned view did not plan the lane route")
        check(view, None, f"{dtype} misaligned view (6,1024)")
    print(f"[mask_pack] exact on bf16/fp16/fp32 with +-0/NaN/+-inf/subnormals, both routes, "
          f"lengths {sorted({b for _, b in MP_CASES})}, a misaligned view: {n_checked} "
          f"cases ok", flush=True)

    rows = []
    for tag, n_blocks, max_len in (("decode leaf, prompt 32", 4 * 16, PROMPT + GEN + 1),
                                   ("decode leaf, prompt 4096", 4 * 16, LONG_PROMPT + GEN + 1),
                                   ("install row, prompt 4096", 16, LONG_PROMPT + GEN + 1)):
        blen = max_len * KV_ROW
        x = _pack_operand(n_blocks, blen, torch.bfloat16, g)
        p = mc.plan(n_blocks, blen, 2, True, n_sms)
        check(x, None, tag)
        check(x, "lane", tag)
        long = blen > 2**20
        iters = 50 if long else 200
        row = {"row": tag, "shape": [n_blocks, blen], "dtype": "bf16", "route": p.route,
               "ctas": p.ctas,
               "ms": timed(lambda: mc.mask_pack(x), iters),
               "device_ms": cold_device_ms(lambda: mc.mask_pack(x)),
               "lane_ms": timed(lambda: mc._launch(x, route="lane"), iters),
               "lane_device_ms": cold_device_ms(lambda: mc._launch(x, route="lane")),
               "plain_ms": timed(lambda: mc.mask_pack_reference(x), 5 if long else 50)}
        n_words = n_blocks * blen // 32
        row["bound_ms"], row["bound_by"] = bound(2.0 * x.numel() + 4.0 * n_words, x.numel())
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        print(f"[mask_pack] {tag} ({n_blocks},{blen}) bf16: stream {row['ms']:.4f} ms a call, "
              f"{row['device_ms']:.4f} ms device time with L2 flushed ({p.ctas} CTAs, "
              f"{row['bound_share']:.0%} of the bound's rate); lane {row['lane_ms']:.4f} / "
              f"{row['lane_device_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del x
    torch.cuda.empty_cache()

    # the launch floor: one word's call on device time
    one = _pack_operand(1, 32, torch.bfloat16, g)
    floor_ms = cold_device_ms(lambda: mc.mask_pack(one))

    # the host time of one call at the decode leaf, and its parts: the
    # wrapper's Python (dtype, contiguity, shape, plan, stream and device
    # lookups, counter), the output's torch.empty, the ctypes call with its
    # launch
    n_blocks, blen = 4 * 16, (PROMPT + GEN + 1) * KV_ROW
    x = _pack_operand(n_blocks, blen, torch.bfloat16, g)
    p = mc.plan(n_blocks, blen, 2, True, n_sms)
    out = torch.empty((n_blocks, blen // 32), dtype=torch.uint32, device=dev)
    lib, ptr, out_ptr, stream = mc._lib(), x.data_ptr(), out.data_ptr(), cuda.stream(dev)

    def enter_device():
        with cuda.on_device(dev):
            pass

    split = {
        "call": host_ms(lambda: mc.mask_pack(x)),
        "empty": host_ms(lambda: torch.empty((n_blocks, blen // 32), dtype=torch.uint32,
                                             device=dev)),
        "ctypes_launch": host_ms(lambda: lib.mask_pack_launch(ptr, out_ptr, n_blocks, blen, 2, 1,
                                                              p.ctas, stream)),
        "plan": host_ms(lambda: mc.plan(n_blocks, blen, 2, ptr % 16 == 0,
                                        cuda.sm_count(dev.index))),
        "stream": host_ms(lambda: cuda.stream(dev)),
        "on_device": host_ms(enter_device),
        "shape": host_ms(lambda: (x.is_contiguous(), math.prod(x.shape[:-1]), x.data_ptr())),
    }
    split["python"] = split["call"] - split["empty"] - split["ctypes_launch"]
    print(f"[mask_pack] launch floor: a one-word (1,32) call takes {floor_ms:.4f} ms of device "
          f"time with L2 flushed (decode leaf {rows[0]['device_ms']:.4f})", flush=True)
    print("[mask_pack] host time of a call at the decode leaf, ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    main = rows[1]
    return {"max_abs_err": float(err), "cases": n_checked, "rows": rows, "floor_ms": floor_ms,
            "host_split": split, "host_ms": split["call"],
            **{k: main[k] for k in ("ms", "device_ms", "lane_ms", "lane_device_ms", "plain_ms",
                                    "bound_ms", "bound_by")}}


# -- slice 2: CNN training ------------------------------------------------------

# VGG-19 at 224 x 224, the paper's training batch (CNNDef.train_batch)
VGG_HW, VGG_BATCH, VGG_STEPS = 224, 32, 3
# backward GEMMs of three VGG-19 layers at batch 32: conv c0_1 (224 x 224,
# 64 -> 64), conv c3_0 (28 x 28, 256 -> 512) and fc6 (25088 -> 4096)
BWD_LAYERS = {"c0_1": ("conv", 224, 64, 64), "c3_0": ("conv", 28, 256, 512),
              "fc6": ("fc", 25088, 4096)}
# prompt 32 and decode ticks of 4 slots: every product on the skinny kernel
SERVE_KERNELS = ("masked_matmul", "masked_matmul_skinny", "mask_pack", "flash_attention")
# the fc forward and fc6 dX at batch 32 take the skinny kernel
TRAIN_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "masked_matmul_skinny",
                 "tile_occupancy", "splitk_reduce", "stochastic_round")


def phase_stochastic_round(dev, gen) -> dict:
    """(a) the SR kernel bit-equal to its plain version on the reference's
    example shapes and on a 32 x 224 x 224 x 64 activation, then timed."""
    import torch

    from repro_torch.kernels.stochastic_round.ops import sr_reference, stochastic_round

    cases = [((128,), 4, 16), ((333, 17), 4, 16), ((8, 1024), 4, 16), ((3, 5, 9), 4, 16),
             ((256, 64), 2, 6), ((VGG_BATCH, VGG_HW, VGG_HW, 64), 4, 16)]
    err = 0.0  # max |kernel - plain| over every case
    for shape, il, fl in cases:
        x = (torch.randn(shape, generator=gen) * 3).to(dev)
        got, want = stochastic_round(x, 9, il=il, fl=fl), sr_reference(x, 9, il=il, fl=fl)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f"stochastic_round {shape} Q{il}.{fl} differs from its plain version")
        del got, want
    print("[stochastic_round] bit-equal to its plain version on the example shapes "
          f"and on {tuple(x.shape)}: ok", flush=True)
    strided = _sr_strided_check(dev, gen)
    ms = timed(lambda: stochastic_round(x, 9), 20)
    plain_ms = timed(lambda: sr_reference(x, 9), 3, warmup=1)
    b_ms, b_by = bound(8.0 * x.numel(), 10.0 * x.numel())
    print(f"[stochastic_round] {tuple(x.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "shape": list(x.shape), "strided": strided}


def _sr_strided_check(dev, gen, model: int = 4) -> dict:
    """The strided counter (tensor parallelism's weight update): every
    rank's column shard of llama3.2-1b's wq (2048, 512 of 2048) and row
    shard of its wo (512 of 2048, 2048), rounded by the kernel with the
    whole leaf's counters, bit-equal to the plain version and to the slice
    of the whole leaf's rounding; the wq shard timed beside an unsharded
    call of its size."""
    import torch

    from repro_torch.kernels.stochastic_round.ops import (shard_counter, sr_reference,
                                                          stochastic_round)

    whole = (torch.randn(LAYER_SHAPES["q"], generator=gen) * 3).to(dev)
    rounded = stochastic_round(whole, 11)
    size = whole.shape[0] // model
    for dim in (1, 0):
        for r in range(model):
            part = whole.narrow(dim, r * size, size).contiguous()
            base, stride = shard_counter(whole.shape, dim, r * size)
            got = stochastic_round(part, 11, base=base, row_stride=stride)
            if not (torch.equal(got, sr_reference(part, 11, base=base, row_stride=stride))
                    and torch.equal(got, rounded.narrow(dim, r * size, size))):
                fail(f"stochastic_round: rank {r}'s {'column' if dim else 'row'} shard "
                     f"{tuple(part.shape)} with the strided counter differs from its plain "
                     "version or from the whole leaf's rounding")
    part = whole[:, size:2 * size].contiguous()
    base, stride = shard_counter(whole.shape, 1, size)
    ms = timed(lambda: stochastic_round(part, 11, base=base, row_stride=stride), 50)
    flat_ms = timed(lambda: stochastic_round(part, 11), 50)
    b_ms, b_by = bound(8.0 * part.numel(), 10.0 * part.numel())
    print(f"[stochastic_round] strided counter: {model} column and {model} row shards of "
          f"{tuple(whole.shape)} bit-equal to the plain version and to the whole leaf's "
          f"rounding; the wq shard {tuple(part.shape)} {ms:.4f} ms strided, {flat_ms:.4f} ms "
          f"with the flat counter, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"shape": list(part.shape), "ms": ms, "flat_ms": flat_ms, "bound_ms": b_ms,
            "bound_by": b_by, "exact": True}


def _relu_sparse(gen, shape, dev):
    import torch

    return torch.relu(torch.randn(shape, generator=gen)).to(dev)


def _coarse01(gen, shape, dev):
    """Values in {0, 2^-8}, half of them zero: every product is 0 or
    2^-16, so a sum of fewer than 2^24 of them is exact in fp32 in any
    order and the kernel must equal the plain product bit for bit."""
    import torch

    return ((torch.rand(shape, generator=gen) < 0.5).to(torch.float32) * 2.0**-8).to(dev)


def phase_backward(dev, gen) -> dict:
    """(b) dx / dw at VGG-19's backward shapes, each operand laid out as the
    training path passes it (conv dW reads the im2col patches transposed,
    conv dX the row-major rot180 weights, fc dX the weights transposed),
    against the plain fp32 product (within 2 K 2^-24 (|a| @ |b|)
    elementwise), bit-identical across two calls, timed beside the plain
    version and torch.matmul; exact on {0, 2^-8} operands at c0_1, where
    a dropped K chunk would show; a block-pruned case whose skip flags must
    equal the plain version's; a split-K forward with SR and the split-K
    reduce, exact on coarse-grid operands."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as mm
    from repro_torch.kernels.masked_matmul.backward import (
        masked_matmul_dw, masked_matmul_dw_reference, masked_matmul_dx,
        masked_matmul_dx_reference)

    rows, err_max = [], {"dx": 0.0, "dw": 0.0}
    for layer, spec in BWD_LAYERS.items():
        if spec[0] == "conv":
            _, hw, cin, cout = spec
            m = VGG_BATCH * hw * hw
            # dW = patches^T @ g: patches (m, cin*9) of a ReLU-sparse input;
            # dX = cotangent patches (m, cout*9) @ rot180 weights wt, which
            # _ConvSparseBackward passes as wt.T (masked_matmul_dx(g, w)
            # computes g @ w.T, so the kernel reads wt row-major)
            dw_ops = (_relu_sparse(gen, (m, cin * 9), dev), _relu_sparse(gen, (m, cout), dev))
            dx_ops = (_relu_sparse(gen, (m, cout * 9), dev),
                      torch.randn(cout * 9, cin, generator=gen).to(dev).T)
        else:
            _, k, n = spec
            dw_ops = (_relu_sparse(gen, (VGG_BATCH, k), dev),
                      _relu_sparse(gen, (VGG_BATCH, n), dev))
            dx_ops = (_relu_sparse(gen, (VGG_BATCH, n), dev),
                      torch.randn(k, n, generator=gen).to(dev))
        for op, (a, b), fn, ref in (
                ("dw", dw_ops, masked_matmul_dw, masked_matmul_dw_reference),
                ("dx", dx_ops, masked_matmul_dx, masked_matmul_dx_reference)):
            # the product's operands as the kernel reads them: (M, K) @ (K, N)
            lhs, rhs = (a.T, b) if op == "dw" else (a, b.T)
            mm_m, mm_k = lhs.shape
            mm_n = rhs.shape[1]
            got, again = fn(a, b), fn(a, b)
            want = ref(a, b)
            tol = 2 * mm_k * 2.0**-24 * (lhs.abs() @ rhs.abs())
            err = (got - want).abs()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"masked_matmul_{op} at {layer} is not deterministic")
            if not bool((err <= tol).all()):
                fail(f"masked_matmul_{op} at {layer} off by {float(err.max()):.3g}")
            del tol, want
            err_max[op] = max(err_max[op], float(err.max()))
            iters = 3 if mm_m * mm_n * mm_k > 1e10 else 20
            ms = timed(lambda: fn(a, b), iters, warmup=1)
            plain_ms = timed(lambda: ref(a, b), iters, warmup=1)
            lib_ms = timed(lambda: torch.matmul(lhs, rhs), iters, warmup=1)
            skip = mm.tile_skip_fraction(lhs, rhs, mm.KERNEL_TILES)
            b_ms, b_by = bound(4.0 * (mm_m * mm_k + mm_k * mm_n + mm_m * mm_n),
                               2.0 * mm_m * mm_n * mm_k * (1 - skip))
            chunks = mm.split_k(mm_k)[1]
            kernel = mm.route(mm_m, mm_n, mm_k)
            rows.append({"op": op, "layer": layer, "shape": [mm_m, mm_k, mm_n],
                         "route": kernel, "chunks": chunks, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "skip": skip, "max_abs_err": float(err.max())})
            print(f"[backward] {op} {layer} ({mm_m},{mm_k})@({mm_k},{mm_n}) {kernel} kernel, "
                  f"split {chunks}: "
                  f"err={float(err.max()):.3g}, deterministic; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}), {ms / lib_ms:.2f}x torch.matmul", flush=True)
            del got, again, err
        del dw_ops, dx_ops, a, b, lhs, rhs
    torch.cuda.empty_cache()

    # exact at c0_1 on {0, 2^-8} operands: dw sums K = 1.6 M products over
    # 196 split-K chunks, dx reads the row-major rot180 weights
    m, cin, cout = VGG_BATCH * 224 * 224, 64, 64
    exact_ops = (("dw", masked_matmul_dw, masked_matmul_dw_reference,
                  _coarse01(gen, (m, cin * 9), dev), _coarse01(gen, (m, cout), dev)),
                 ("dx", masked_matmul_dx, masked_matmul_dx_reference,
                  _coarse01(gen, (m, cout * 9), dev), _coarse01(gen, (cout * 9, cin), dev).T))
    for op, fn, ref, a, b in exact_ops:
        got, want = fn(a, b), ref(a, b)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err_max[op] = max(err_max[op], e)
        if not torch.equal(got, want):
            fail(f"masked_matmul_{op} at c0_1 on {{0, 2^-8}} operands is off by {e:.3g}")
        print(f"[backward] {op} c0_1 on {{0, 2^-8}} operands: bit-equal to the plain product",
              flush=True)
        del got, want
    del exact_ops, a, b
    torch.cuda.empty_cache()

    # block-pruned: whole 64-row tiles of x (dw reads x^T) and of the
    # cotangent are zero; the kernel's flags of the transposed operand must
    # equal the plain flags of the transpose, and tiles must be skipped
    tm, tn, tk = mm.KERNEL_TILES
    x = _relu_sparse(gen, (4096, 576), dev)
    g = _relu_sparse(gen, (4096, 64), dev)
    x[: 4096 // 2] = 0.0
    g[1024:1536] = 0.0
    flags = mm.tile_occupancy(x, tk, tm).t()
    if not torch.equal(flags, mm.tile_occupancy_reference(x.T, tm, tk)):
        fail("masked_matmul_dw: transposed-operand skip flags differ from the plain version's")
    with mm.record_tile_skip() as rec:
        got = masked_matmul_dw(x, g)
    skip = 1.0 - rec["masked_matmul_dw"][0] / rec["masked_matmul_dw"][1]
    want_skip = mm.tile_skip_fraction(x.T, g, mm.KERNEL_TILES)
    err = float((got - masked_matmul_dw_reference(x, g)).abs().max())
    print(f"[backward] block-pruned dw (576,4096)@(4096,64): flags equal to the plain "
          f"version's, skip {skip:.3f} (plain {want_skip:.3f}), err {err:.3g}", flush=True)
    if skip <= 0.0 or abs(skip - want_skip) > 1e-12:
        fail("masked_matmul_dw on block-pruned operands: skipped tiles disagree")

    # split-K forward with the SR epilogue (fc6 at batch 32): exact on the
    # 2^-8 grid, where every sum is exact whatever its order
    xs = torch.round(torch.randn(VGG_BATCH, 25088, generator=gen) * 2**2) / 2**8
    ws = torch.round(torch.randn(25088, 64, generator=gen) * 2**2) / 2**8
    xs, ws = xs.to(dev), ws.to(dev)
    got, want = mm.masked_matmul(xs, ws, 5), mm.masked_matmul_reference(xs, ws, 5)
    red_err = float((got - want).abs().max())  # max |kernel - plain| over every reduce
    if not torch.equal(got, want):
        fail("masked_matmul split-K forward with SR differs from its plain version")
    part = torch.randn(196, 576, 64, generator=gen).to(dev)
    # c0_1's dW partials, then N = 50 from a base 4 bytes past 16-byte
    # alignment (scalar loads) and an M * N that fills no block
    flat = torch.randn(1 + 7 * 70 * 50, generator=gen).to(dev)
    for pt in (part, flat[1:].view(7, 70, 50), flat[:17 * 5 * 50].view(17, 5, 50)):
        for sr in (False, True):
            got = mm.splitk_reduce(pt, 3, apply_sr=sr)
            want = mm.splitk_reduce_reference(pt, 3, apply_sr=sr)
            red_err = max(red_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"splitk_reduce {tuple(pt.shape)} differs from its plain version")
    # ms: a loop of calls, as every row has it (the call is about as short
    # on the card as its host time, so it is long enough for the host to
    # pace); device_ms: the kernel alone with the partials out of L2, to
    # hold against the byte bound
    red_ms = timed(lambda: mm.splitk_reduce(part), 200, warmup=20)
    red_lib_ms = timed(lambda: torch.sum(part, 0), 200, warmup=20)
    red_plain_ms = timed(lambda: mm.splitk_reduce_reference(part), 3, warmup=1)
    red_dev_ms = cold_device_ms(lambda: mm.splitk_reduce(part))
    red_lib_dev_ms = cold_device_ms(lambda: torch.sum(part, 0))
    red_host_ms = host_ms(lambda: mm.splitk_reduce(part))
    red_lib_host_ms = host_ms(lambda: torch.sum(part, 0))
    red_b, red_by = bound(4.0 * (part.numel() + part[0].numel()), part.numel())
    print(f"[backward] split-K forward with SR (32,25088)@(25088,64) exact; splitk_reduce "
          f"(196,576,64), (7,70,50) unaligned and (17,5,50) exact; at c0_1 a call: kernel "
          f"{red_ms:.5f} ms, torch.sum {red_lib_ms:.5f} ms; device time, L2 flushed: kernel "
          f"{red_dev_ms:.5f} ms, torch.sum {red_lib_dev_ms:.5f} ms; host time a call: kernel "
          f"{red_host_ms:.5f} ms, torch.sum {red_lib_host_ms:.5f} ms; plain {red_plain_ms:.4f} "
          f"ms, bound {red_b:.5f} ms ({red_by})", flush=True)
    return {"rows": rows, "err": err_max,
            "reduce": {"ms": red_ms, "device_ms": red_dev_ms, "plain_ms": red_plain_ms,
                       "library_ms": red_lib_ms, "library_device_ms": red_lib_dev_ms,
                       "host_ms": red_host_ms, "library_host_ms": red_lib_host_ms,
                       "bound_ms": red_b, "bound_by": red_by, "max_abs_err": red_err,
                       "shape": "c0_1 dw partial sums (196, 576, 64)"}}


def profile_train_step(dev, params, memstash) -> dict:
    """One VGG-19 train step under torch.profiler: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fixedpoint import SPRING_FORMAT
    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.data.pipeline import DataConfig, SyntheticImageTask
    from repro_torch.launch.train import MODELS
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import StepConfig, init_train_state, make_cnn_train_step

    step_cfg = StepConfig(spring=QUANT_SPARSE, memstash=memstash,
                          optimizer=OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9,
                                                    weight_format=SPRING_FORMAT))
    step = make_cnn_train_step(MODELS["vgg19"].fn, step_cfg)
    state = init_train_state(params, step_cfg, seed=1)
    x, y = SyntheticImageTask(DataConfig(seed=1, global_batch=VGG_BATCH), hw=VGG_HW,
                              device=dev).batch(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"[train-profile] step {wall_ms:.1f} ms wall; device time not measured", flush=True)
    else:
        print(f"[train-profile] step {wall_ms:.1f} ms wall (profiled), device busy "
              f"{busy:.1f} ms = {busy / wall_ms:.1%}; top kernels:", flush=True)
        for name, ms, n in rows[:14]:
            print(f"[train-profile]   {ms:9.2f} ms  x{n:<5d} {name[:90]}", flush=True)
    return {"step_ms": wall_ms, "device_busy_ms": busy,
            "kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:40]]}


def phase_train(dev) -> dict:
    """(c) full-width VGG-19, quant_sparse, SR, sparse backward, the stash
    policy, sgdm with Q4.16 SR weights, through repro_torch.launch.train;
    the kernels' launch counters are zeroed just before and read just
    after; then one profiled step."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch.train import run_arm
    from repro_torch.memstash.config import STASH_ALL

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = run_arm("vgg19", "vgg19", "quant_sparse", True, VGG_STEPS, VGG_HW, VGG_BATCH, dev,
                  STASH_ALL, seed=0, probe_step=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    probe = out["probe"]
    print(f"[train] vgg19 {VGG_HW}x{VGG_HW} batch {VGG_BATCH} quant_sparse SR stash: losses "
          f"{[round(v, 4) for v in out['losses']]}, on grid {out['on_grid']}, "
          f"{out['s_per_step']:.3f} s/step, {out['images_per_s']:.2f} images/s, peak "
          f"{out['peak_mem_bytes'] / 2**30:.2f} GiB, wall {wall:.1f}s", flush=True)
    print(f"[train] activation density {probe['stash']['mean_density']:.3f} over "
          f"{probe['stash']['stash_points']} stash points; tile skip "
          f"{ {k: round(v, 4) for k, v in probe['tile_skip'].items()} }; launches {launches}",
          flush=True)
    if not (out["finite"] and all(out["on_grid"]) and len(out["on_grid"]) == VGG_STEPS):
        fail("train phase: a loss is not finite or a parameter left the Q4.16 grid")
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"train phase never launched the {name} kernel")
    prof = profile_train_step(dev, out.pop("params"), STASH_ALL)
    return {"run": out, "launches": launches, "wall_s": wall, "profile": prof}


def phase_cnn_card_vs_cpu(dev) -> dict:
    """(d) the reduced CNN (the example's tiny_cnn) one train step on the
    card against the same step on the CPU: quant_sparse, nearest rounding,
    fp32 weights, stash.  Tolerance: the CPU parity tests' gradient
    contract (rtol 1e-5, floor 1e-5 x max), since the conv and the products
    sum in another order and a rounding can move one 2^-16 step."""
    import dataclasses

    import torch

    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.data.pipeline import DataConfig, SyntheticImageTask
    from repro_torch.launch.train import MODELS, tiny_cnn
    from repro_torch.models.cnn import cnn_init
    from repro_torch.memstash.config import STASH_ALL
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import StepConfig, init_train_state, make_cnn_train_step

    step_cfg = StepConfig(spring=dataclasses.replace(QUANT_SPARSE, stochastic=False),
                          memstash=STASH_ALL,
                          optimizer=OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9))
    params = cnn_init(0, MODELS["tiny_cnn"], 16)
    x, y = SyntheticImageTask(DataConfig(seed=0, global_batch=8), hw=16).batch(0)
    res = {}
    for d in ("cpu", dev):
        state = init_train_state({k: v.to(d) for k, v in params.items()}, step_cfg, 0)
        state, m = make_cnn_train_step(tiny_cnn, step_cfg)(state, x.to(d), y.to(d))
        res[str(d)] = (float(m["loss"]), {k: v.cpu() for k, v in state.params.items()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = res["cpu"], res[str(dev)]
    worst = 0.0
    for k in p_cpu:
        tol = 1e-5 * (float(p_cpu[k].abs().max()) + 1.0) + 1e-5 * p_cpu[k].abs()
        diff = (p_gpu[k] - p_cpu[k]).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= tol).all()):
            fail(f"tiny_cnn step on the card disagrees with the CPU at {k}")
    print(f"[check] tiny_cnn one step card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f}, params "
          f"max_abs_err {worst:.3g} (rtol 1e-5, floor 1e-5 x max)", flush=True)
    if abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu):
        fail("tiny_cnn loss on the card disagrees with the CPU")
    return {"loss_card": l_gpu, "loss_cpu": l_cpu, "params_max_abs_err": worst}


def phase_arms(dev) -> dict:
    """(e) the example's three arms on tiny_cnn; printed, not gated."""
    from repro_torch.launch.train import parity_arms

    out = parity_arms(steps=150, device=dev)
    print(f"[arms] tiny_cnn 150 steps tail loss: fp32 {out['fp32']['tail']:.4f}, SR "
          f"{out['sr']['tail']:.4f}, nearest {out['nearest']['tail']:.4f}; SR gap "
          f"{out['sr_gap']:+.4f}, nearest gap {out['nearest_gap']:+.4f}", flush=True)
    return out


# -- slice 12: LM training --------------------------------------------------------

# 5f: the example train spec at full width through the launcher and in
# process.  Every product of its shape (batch 8, seq 128) has M = 1,024
# (forward, dX) or K = 1,024 (dW) and K <= 8,192, so the tile kernel takes
# them all; one step of the same spec at batch 1, seq 32 (M = 32: the
# skinny kernel) and one at seq 1,040 (dW's K = 8,320 > 8,192: split-K and
# its reduce) drive the two other routes of the LM train path
TRAIN_SPEC_FILE = "examples/specs/train_quant_sparse.json"
TRAIN_LM_STEPS = 6
TRAIN_LM_SETS = ("arch.reduced=false", f"train.steps={TRAIN_LM_STEPS}", "train.ckpt_dir=")
TRAIN_LM_EDGES = {"skinny": ("shape.batch=1", "shape.seq=32"),
                  "split-K": ("shape.seq=1040",)}
TRAIN_LM_KERNELS = ("masked_matmul", "masked_matmul_skinny", "tile_occupancy",
                    "masked_matmul_dx", "masked_matmul_dw", "splitk_reduce", "stochastic_round")
TRAIN_LM_TIMEOUT_S = 300
#: the reference's SR-vs-fp32 claim (tests/test_system.py:38-45) and its
#: resume contract (tests/test_system.py:26-35), reduced llama3.2-1b
SR_CLAIM = dict(steps=60, batch=8, seq=64)
RESUME = dict(batch=4, seq=32)


def _train_lm_kernel_checks(dev, cfg, batch: int, seq: int, prune_ratio: float = 0.0,
                            phase: str = "train_lm") -> dict:
    """Each kernel of the LM train path on card tensors at the shapes the
    path gives it, against its plain version (``prune_ratio``: every
    weight magnitude-pruned as ``SpringContext.maybe_prune`` prunes it
    inline): the forward (tile kernel,
    exact occupancy flags), dX and dW of the seven projections at M =
    batch x seq within 2b's bound 2 K 2**-24 (|a| @ |b|); the forward and
    dX at M = 32 (the skinny kernel); splitk_reduce bit-equal on dW
    partials of the split-K edge; stochastic_round bit-equal at the
    embedding's (vocab, d_model)."""
    import torch

    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.masked_matmul.backward import (
        masked_matmul_dw, masked_matmul_dw_reference, masked_matmul_dx,
        masked_matmul_dx_reference)
    from repro_torch.kernels.masked_matmul.ops import (
        KERNEL_TILES, SPLIT_K, masked_matmul, masked_matmul_reference, route, splitk_reduce,
        splitk_reduce_reference, tile_occupancy, tile_occupancy_reference)
    from repro_torch.kernels.stochastic_round.ops import sr_reference, stochastic_round
    from repro_torch.models.layers import SpringContext

    prune = SpringContext(prune_ratio=prune_ratio).maybe_prune
    g = torch.Generator(device=dev).manual_seed(12)
    tm, tn, tk = KERNEL_TILES
    a, d, ff = cfg.attn, cfg.d_model, cfg.d_ff
    projs = {"q": (d, a.n_heads * a.head_dim), "k": (d, a.n_kv_heads * a.head_dim),
             "v": (d, a.n_kv_heads * a.head_dim), "o": (a.n_heads * a.head_dim, d),
             "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    errs = dict.fromkeys(("forward", "skinny", "dx", "dw", "splitk_reduce",
                          "stochastic_round", "tile_occupancy"), 0.0)

    def q(*shape, scale=1.0):
        return quantize_nearest(torch.randn(*shape, generator=g, device=dev) * scale)

    def within(got, want, bound, what) -> float:
        err = (got - want).abs_()
        if not bool((err <= bound).all()):
            fail(f"{phase} check: {what} off by {float(err.max()):.3g}")
        return float(err.max())

    def flags_exact(t, rows, cols, what) -> None:
        if not torch.equal(tile_occupancy(t, rows, cols), tile_occupancy_reference(t, rows, cols)):
            fail(f"{phase} check: tile_occupancy of {what} disagrees with its plain version")

    for m in (batch * seq, PREFILL_M):
        kind = "forward" if route(m, 1, 1) == "tile" else "skinny"
        for name, (k, n) in projs.items():
            x, w = q(m, k), prune(q(k, n, scale=k**-0.5))
            if kind == "forward":
                flags_exact(x, tm, tk, f"x ({m},{k})")
                flags_exact(w, tk, tn, f"w ({k},{n})")
            bnd = (x.abs() @ w.abs()).mul_(2 * k * 2.0**-24)
            errs[kind] = max(errs[kind], within(
                masked_matmul(x, w, apply_sr=False),
                masked_matmul_reference(x, w, apply_sr=False), bnd, f"{name} forward M {m}"))
            cot = torch.randn(m, n, generator=g, device=dev).mul_(1e-3)
            bnd = (cot.abs() @ w.abs().T).mul_(2 * n * 2.0**-24)
            errs["dx" if kind == "forward" else "skinny"] = max(
                errs["dx" if kind == "forward" else "skinny"],
                within(masked_matmul_dx(cot, w), masked_matmul_dx_reference(cot, w), bnd,
                       f"{name} dx M {m}"))
            if kind == "forward":
                bnd = (x.abs().T @ cot.abs()).mul_(2 * m * 2.0**-24)
                errs["dw"] = max(errs["dw"], within(
                    masked_matmul_dw(x, cot), masked_matmul_dw_reference(x, cot), bnd,
                    f"{name} dw M {m}"))
            del x, w, cot, bnd
    # dW of gate at the split-K edge: K = 8 x 1040 rows in two chunks
    part = q(-(-8 * 1040 // SPLIT_K), d, ff)
    if not torch.equal(splitk_reduce(part), splitk_reduce_reference(part)):
        fail(f"{phase} check: splitk_reduce {tuple(part.shape)} differs from its plain version")
    del part
    emb = torch.randn(cfg.vocab, d, generator=g, device=dev).mul_(0.02)
    got, want = stochastic_round(emb, 5), sr_reference(emb, 5)
    if not torch.equal(got, want):
        fail(f"{phase} check: stochastic_round {tuple(emb.shape)} differs from its plain version")
    del emb, got, want
    torch.cuda.empty_cache()
    print(f"[{phase}] kernels at the path's shapes against their plain versions"
          f"{' (weights pruned at ' + str(prune_ratio) + ')' if prune_ratio else ''}: tile "
          f"forward {errs['forward']:.3g}, dx {errs['dx']:.3g}, dw {errs['dw']:.3g} (M "
          f"{batch * seq}), skinny forward and dx {errs['skinny']:.3g} (M {PREFILL_M}); "
          f"tile_occupancy, splitk_reduce and stochastic_round ({cfg.vocab},{d}) bit-equal",
          flush=True)
    return errs


def phase_train_lm(dev) -> dict:
    """(5f) LM training from the example spec: full-width llama3.2-1b
    through ``python -m repro_torch.launch.train`` as a subprocess (exit
    0, the reference's last line with the spec_hash of the in-process
    build, finite losses); the same spec in process with telemetry on
    (its ``train.step`` spans give s/step), then one step at each of the
    two other routes, the launch counters zeroed just before the first run
    and read just after the last (every kernel of TRAIN_LM_KERNELS must
    launch), every parameter on the Q4.16 grid after the last step, peak
    memory; one step under torch.profiler; each path kernel against its
    plain version at the path's shapes; at reduced size the reference's
    SR-vs-fp32 claim and its resume contract."""
    import math
    import os
    import re
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.api import TrainSession, build_spec
    from repro_torch.launch.train import on_grid, train_loop
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.train import make_train_step

    t_phase = time.monotonic()
    spec_path = str(ROOT / TRAIN_SPEC_FILE)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    try:
        # -- the launcher, as a user runs it ------------------------------------
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--spec", spec_path,
                *[arg for item in TRAIN_LM_SETS for arg in ("--set", item)],
                "--json", str(tmp / "launcher.json")]
        t0 = time.monotonic()
        p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=TRAIN_LM_TIMEOUT_S)
        launcher_wall = time.monotonic() - t0
        if p.returncode != 0:
            fail(f"train LM phase: the launcher exited {p.returncode}:\n{p.stdout[-2000:]}\n"
                 f"{p.stderr[-4000:]}")
        spec = build_spec("train", spec_file=spec_path, sets=list(TRAIN_LM_SETS))
        last = p.stdout.strip().splitlines()[-1]
        launched = json.loads((tmp / "launcher.json").read_text())
        want_last = (f"loss {launched['first_loss']:.4f} -> {launched['last_loss']:.4f} "
                     f"({TRAIN_LM_STEPS} steps, slow={launched['slow_steps']}) "
                     f"[spec {spec.spec_hash()}]")
        print(f"[train_lm] launcher: {last} (wall {launcher_wall:.1f} s)", flush=True)
        if last != want_last or not re.fullmatch(r"loss \S+ -> \S+ \(\d+ steps, slow=\d+\) "
                                                 r"\[spec [0-9a-f]+\]", last):
            fail(f"train LM phase: the launcher's last line {last!r} is not {want_last!r}")
        if len(launched["losses"]) != TRAIN_LM_STEPS or not all(
                math.isfinite(v) for v in launched["losses"]):
            fail("train LM phase: the launcher's losses are not all finite")

        # -- the same spec in process, then the two route edges -----------------
        trace = tmp / "trace.json"
        inproc = build_spec("train", spec_file=spec_path, sets=[
            *TRAIN_LM_SETS, "telemetry.enabled=true", f"telemetry.trace_path={trace}"])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = TrainSession(inproc, device=dev).run()
        torch.cuda.synchronize()
        inproc_wall = time.monotonic() - t0
        main_launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        state = out.pop("state")
        grid = on_grid(dict(enumerate(tree_leaves(state.params))))
        steps_s = [ev["dur"] / 1e6 for ev in json.loads(trace.read_text())["traceEvents"]
                   if ev["name"] == "train.step"]
        s_per_step = sum(steps_s[1:]) / len(steps_s[1:])
        tokens_per_s = spec.shape.batch * spec.shape.seq / s_per_step
        edges = {}
        for name, sets in TRAIN_LM_EDGES.items():
            before = kernels.launch_counts()
            t0 = time.monotonic()
            e = TrainSession(build_spec("train", spec_file=spec_path, sets=[
                *TRAIN_LM_SETS, "train.steps=1", *sets]), device=dev).run()
            torch.cuda.synchronize()
            edges[name] = {"loss": e["losses"][0], "wall_s": time.monotonic() - t0,
                           "launches": {k: v - before[k]
                                        for k, v in kernels.launch_counts().items()}}
            del e
        launches = kernels.launch_counts()
        per_step = {k: main_launches[k] / TRAIN_LM_STEPS for k in TRAIN_LM_KERNELS}
        print(f"[train_lm] in process: losses {[round(v, 4) for v in out['losses']]}, on grid "
              f"{grid}, {s_per_step:.4f} s/step (steps {[round(s, 4) for s in steps_s]}), "
              f"{tokens_per_s:.1f} tokens/s, peak {peak / 2**30:.2f} GiB, wall "
              f"{inproc_wall:.1f} s", flush=True)
        print(f"[train_lm] launches a step (batch {spec.shape.batch}, seq {spec.shape.seq}): "
              f"{per_step}", flush=True)
        for name, e in edges.items():
            print(f"[train_lm] {name} edge step: loss {e['loss']:.4f}, wall {e['wall_s']:.1f} "
                  f"s, launches { {k: e['launches'][k] for k in TRAIN_LM_KERNELS} }",
                  flush=True)
        if not (all(math.isfinite(v) for v in out["losses"]) and grid
                and all(math.isfinite(e["loss"]) for e in edges.values())):
            fail("train LM phase: a loss is not finite or a parameter left the Q4.16 grid")
        for name in TRAIN_LM_KERNELS:
            if launches[name] <= 0:
                fail(f"train LM phase never launched the {name} kernel")
        if launches["flash_attention"] != 0:
            fail("train LM phase launched flash_attention (training takes chunked attention)")

        # -- one step under the profiler ----------------------------------------
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.data.pipeline import DataConfig, SyntheticLMStream

        r = inproc.resolve()
        step = make_train_step(r.view, r.step)
        tokens = SyntheticLMStream(DataConfig(seed=0, vocab=r.config.vocab, seq_len=spec.shape.seq,
                                              global_batch=spec.shape.batch),
                                   device=dev).batch(TRAIN_LM_STEPS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, _ = step(state, {"tokens": tokens})
            torch.cuda.synchronize()
            prof_ms = (time.monotonic() - t0) * 1e3
        del state, step
        rows = device_time_by_kernel(prof)
        busy = sum(row[1] for row in rows)
        print(f"[train_lm] profiled step {prof_ms:.1f} ms wall, device busy {busy:.1f} ms "
              f"({busy / prof_ms:.1%}); top kernels:", flush=True)
        for name, ms, n in rows[:14]:
            print(f"[train_lm]   {ms:9.2f} ms  x{n:<5d} {name[:90]}", flush=True)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    errs = _train_lm_kernel_checks(dev, r.config, spec.shape.batch, spec.shape.seq)

    # -- reduced: the SR-vs-fp32 claim and the resume contract -------------------
    t0 = time.monotonic()
    fp32 = train_loop("llama3.2-1b", reduced=True, mode="dense", device=dev, **SR_CLAIM)
    srq = train_loop("llama3.2-1b", reduced=True, mode="quant", fixed_point_weights=True,
                     device=dev, **SR_CLAIM)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        straight = train_loop("llama3.2-1b", reduced=True, steps=30, device=dev, **RESUME)
        train_loop("llama3.2-1b", reduced=True, steps=20, ckpt_dir=ckpt, ckpt_every=10,
                   device=dev, **RESUME)
        resumed = train_loop("llama3.2-1b", reduced=True, steps=30, ckpt_dir=ckpt,
                             ckpt_every=10, device=dev, **RESUME)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    reduced_wall = time.monotonic() - t0
    resume_rel = abs(resumed["losses"][-1] - straight["losses"][-1]) / abs(straight["losses"][-1])
    print(f"[train_lm] reduced SR claim ({SR_CLAIM}): fp32 {fp32['first_loss']:.4f} -> "
          f"{fp32['last_loss']:.4f}, Q4.16 SR {srq['first_loss']:.4f} -> "
          f"{srq['last_loss']:.4f}; resume: last loss {resumed['losses'][-1]:.6f} vs "
          f"{straight['losses'][-1]:.6f} straight (rel {resume_rel:.3g}); wall "
          f"{reduced_wall:.1f} s", flush=True)
    if not srq["last_loss"] < srq["first_loss"] - 0.3:
        fail("train LM phase: SR fixed-point training did not learn (tests/test_system.py:43)")
    if not srq["last_loss"] < fp32["last_loss"] + 0.6:
        fail("train LM phase: SR fixed-point training diverged from fp32 "
             "(tests/test_system.py:44)")
    if len(resumed["losses"]) != 10 or not resume_rel <= 1e-4:
        fail("train LM phase: the resumed run's last loss differs from the straight run's")
    wall = time.monotonic() - t_phase
    print(f"[train_lm] phase 5f wall {wall:.1f} s", flush=True)
    return {"launches": launches, "main_launches": main_launches,
            "launches_per_step": per_step, "edges": edges,
            "losses": out["losses"], "launcher_losses": launched["losses"],
            "launcher_wall_s": launcher_wall, "in_process_wall_s": inproc_wall,
            "steps_s": steps_s, "s_per_step": s_per_step, "tokens_per_s": tokens_per_s,
            "peak_mem_bytes": peak, "on_grid": grid, "errs": errs,
            "profile": {"step_ms": prof_ms, "device_busy_ms": busy,
                        "kernels": [{"name": n, "ms": ms, "calls": c}
                                    for n, ms, c in rows[:40]]},
            "sr_claim": {"fp32": fp32["losses"], "sr": srq["losses"]},
            "resume": {"straight": straight["losses"][-1], "resumed": resumed["losses"][-1],
                       "rel": resume_rel},
            "reduced_wall_s": reduced_wall, "wall_s": wall}


# -- slice 16: the rest of LM training ----------------------------------------------

# 5g: mamba2-780m whole from the example spec in process (its launcher run
# went for 8i's time: 5f runs the launcher); olmoe-1b-7b (and once more with
# its unit stashed),
# deepseek-v2-lite-16b, recurrentgemma-9b, whisper-medium (whole, with
# frames) and internvl2-26b (with its image prefix) in process through
# make_train_step.  Batch 8, seq 128, every width, random weights from seed
# 0, the example train spec's numerics (quant_sparse, SR, Q4.16 SR
# weights, AdamW with warmup, the sparse backward)
TRAIN_ARCHS_BATCH, TRAIN_ARCHS_SEQ = 8, 128
MAMBA_TRAIN_SETS = ("arch.id=mamba2-780m", "arch.reduced=false", "train.steps=3",
                    "train.ckpt_dir=")
#: whole units kept of the archs that do not fit whole beside their
#: gradients and AdamW moments (16 bytes a parameter, updated in place):
#: the largest depth that leaves TRAIN_ARCHS_HEADROOM of the card free at
#: the part's peak (H100 80GB HBM3), but for the MoE archs, cut further for
#: the time limit when phase 8h came (olmoe 11 -> 4 layers, deepseek 7 -> 3
#: units: the same branches and kernels, fewer repeats)
TRAIN_ARCHS_UNITS = {"olmoe-1b-7b": 4, "deepseek-v2-lite-16b": 3, "recurrentgemma-9b": 3,
                     "internvl2-26b": 9}
TRAIN_ARCHS_HEADROOM = 4 * 2**30
#: the most elements stochastic_round is held against its plain version
#: on: the plain version's int64 hash temporaries take about 67 bytes an
#: element, and recurrentgemma-9b's (256000, 4096) embedding ran the card
#: out of memory there (measured on one H100 80GB HBM3)
TRAIN_ARCHS_SR_ELEMS = 2**29
TRAIN_ARCHS_KERNELS = ("masked_matmul", "tile_occupancy", "masked_matmul_dx",
                       "masked_matmul_dw", "stochastic_round")
#: the parts with a product whose K exceeds SPLIT_K at these shapes:
#: deepseek's dense prefix (d_ff 10944), recurrentgemma's (12288) and
#: internvl2's (16384) FFNs, whisper's encoder dW (K = 8 x 1500 rows);
#: olmoe's and mamba2's products all have K <= 8192, and launch none
TRAIN_ARCHS_SPLITK = ("deepseek-v2-lite-16b", "recurrentgemma-9b", "whisper-medium",
                      "internvl2-26b")


def _cut(cfg, units: int):
    """``cfg`` (an LMConfig) with ``units`` repeats of its unit, every width
    and its prefix and suffix kept."""
    import dataclasses

    n = len(cfg.prefix) + units * len(cfg.pattern_unit) + len(cfg.suffix)
    return dataclasses.replace(cfg, n_units=units, n_layers=n)


def _train_part(dev, tag: str, view, step_cfg, steps: int, batch_at, routing=None,
                profiled: bool = True, phase: str = "train_archs", inspect=None) -> dict:
    """Train ``view`` in process: a fresh state from seed 0 on the card,
    ``steps`` steps of ``make_train_step`` on ``batch_at(i)``, each timed
    to its synchronise, then (``profiled``) one more under torch.profiler.
    Returns the losses, s/step after step 0, tokens/s, the peak and the
    card's memory left free at it, the launches of the run, the on-grid
    check of every parameter, the profiled step's kernels by device time
    (None unprofiled), and what
    ``routing(final state)`` returns (a MoE arch's :func:`_routing`) and
    ``inspect(final state, step function)``, each after the profiled step.
    ``phase`` labels the printed lines and the failures."""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.launch.train import on_grid
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    t0 = time.monotonic()
    state = init_train_state(view, step_cfg, 0, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    step_fn = make_train_step(view, step_cfg)
    losses, auxs, step_s = [], [], []
    for i in range(steps):
        batch = batch_at(i)
        t = time.monotonic()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        losses.append(float(m["loss"]))
        auxs.append(float(m["aux"]) if "aux" in m else 0.0)
    grid = on_grid(dict(enumerate(tree_leaves(state.params))))
    prof = None
    if profiled:
        state, prof = _profiled_step(step_fn, state, batch_at(steps))
    peak = torch.cuda.max_memory_allocated(dev)
    free = torch.cuda.get_device_properties(dev).total_memory - peak
    launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    s_per_step = sum(step_s[1:]) / len(step_s[1:])
    tokens = batch["tokens"].numel()
    res = {"params": n_params, "losses": losses, "aux": auxs, "steps_s": step_s,
           "s_per_step": s_per_step, "tokens_per_s": tokens / s_per_step,
           "peak_bytes": peak, "free_bytes": free, "on_grid": grid, "launches": launches,
           "profile": prof, "wall_s": time.monotonic() - t0}
    print(f"[{phase}] {tag}: {n_params / 1e9:.3f} B parameters, losses "
          f"{[round(v, 4) for v in losses]}, aux {[round(v, 4) for v in auxs]}, on grid "
          f"{grid}, {s_per_step:.3f} s/step (steps {[round(s, 3) for s in step_s]}), "
          f"{tokens / s_per_step:.1f} tokens/s, peak {peak / 2**30:.2f} GiB, "
          f"{free / 2**30:.2f} GiB free, wall {res['wall_s']:.1f} s; launches "
          f"{ {k: launches[k] for k in (*TRAIN_ARCHS_KERNELS, 'splitk_reduce')} }", flush=True)
    if prof is not None:
        _print_profile(tag, prof, phase)
    if not (all(math.isfinite(v) for v in losses) and grid):
        fail(f"{phase} phase: {tag}'s losses are not all finite or a parameter left the "
             "Q4.16 grid")
    if free < TRAIN_ARCHS_HEADROOM:
        fail(f"{phase} phase: {tag} left {free / 2**30:.2f} GiB of the card free at its "
             f"peak, under {TRAIN_ARCHS_HEADROOM / 2**30:.0f} GiB")
    if routing is not None:
        t = time.monotonic()
        res["routing"] = routing(state)
        res["routing"]["wall_s"] = time.monotonic() - t
    if inspect is not None:
        res["inspect"] = inspect(state, step_fn)
    return res


def _profiled_step(step_fn, state, batch) -> tuple:
    """One more train step under torch.profiler (device activity only: a
    MoE step issues some 10**5 kernels, and host events would multiply the
    trace): (the new state, {"step_ms", "device_busy_ms", "kernels",
    "read_s"}), the kernels by device time, busiest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t) * 1e3
    t = time.monotonic()
    rows = device_time_by_kernel(prof)
    return state, {"step_ms": step_ms, "device_busy_ms": sum(r[1] for r in rows),
                   "kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:30]],
                   "read_s": time.monotonic() - t}


def _print_profile(tag: str, prof: dict, phase: str = "train_archs") -> None:
    busy, step_ms = prof["device_busy_ms"], prof["step_ms"]
    print(f"[{phase}] {tag}: profiled step {step_ms:.1f} ms wall, device busy {busy:.1f} ms "
          f"({busy / step_ms:.1%}; the trace read in {prof['read_s']:.1f} s); top kernels:",
          flush=True)
    for row in prof["kernels"][:8]:
        print(f"[{phase}]   {row['ms']:9.2f} ms  x{row['calls']:<6d} {row['name'][:90]}",
              flush=True)


def _train_mamba2(dev, tmp) -> dict:
    """mamba2-780m whole from the example spec in process with telemetry
    on (s/step from its train.step spans, peak, on grid), and one more step
    profiled.  (Its launcher run went for 8i's time: 5f runs the same spec
    through the launcher, and 8i trains mamba2 whole beside its shards.)"""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.api import TrainSession, build_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import on_grid
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.train import make_train_step

    spec_path = str(ROOT / TRAIN_SPEC_FILE)
    spec = build_spec("train", spec_file=spec_path, sets=list(MAMBA_TRAIN_SETS))
    steps = spec.train.steps
    trace = tmp / "mamba2_trace.json"
    inproc = build_spec("train", spec_file=spec_path, sets=[
        *MAMBA_TRAIN_SETS, "telemetry.enabled=true", f"telemetry.trace_path={trace}"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernels.launch_counts()
    t0 = time.monotonic()
    out = TrainSession(inproc, device=dev).run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    state = out.pop("state")
    grid = on_grid(dict(enumerate(tree_leaves(state.params))))
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    r = inproc.resolve()
    stream = SyntheticLMStream(DataConfig(seed=0, vocab=r.config.vocab, seq_len=spec.shape.seq,
                                          global_batch=spec.shape.batch), device=dev)
    state, prof = _profiled_step(make_train_step(r.view, r.step), state,
                                 {"tokens": stream.batch(steps)})
    del state
    steps_s = [ev["dur"] / 1e6 for ev in json.loads(trace.read_text())["traceEvents"]
               if ev["name"] == "train.step"]
    s_per_step = sum(steps_s[1:]) / len(steps_s[1:])
    tokens_per_s = spec.shape.batch * spec.shape.seq / s_per_step
    free = torch.cuda.get_device_properties(dev).total_memory - peak
    print(f"[train_archs] mamba2-780m in process: {n_params / 1e9:.3f} B parameters, losses "
          f"{[round(v, 4) for v in out['losses']]}, on grid {grid}, {s_per_step:.3f} "
          f"s/step (steps {[round(s, 3) for s in steps_s]}), {tokens_per_s:.1f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB, wall {wall:.1f} s; launches "
          f"{ {k: launches[k] for k in (*TRAIN_ARCHS_KERNELS, 'ssd_scan')} }", flush=True)
    _print_profile("mamba2-780m", prof)
    if not (all(math.isfinite(v) for v in out["losses"]) and grid):
        fail("train archs phase: mamba2-780m's losses are not all finite or a parameter left "
             "the Q4.16 grid")
    return {"params": n_params, "losses": out["losses"], "steps_s": steps_s,
            "s_per_step": s_per_step, "tokens_per_s": tokens_per_s, "peak_bytes": peak,
            "free_bytes": free,
            "on_grid": grid, "launches": launches, "profile": prof, "wall_s": wall}


def _train_product_checks(g, products: dict, tag: str) -> tuple:
    """The train path's products ``{name: (M, K, N)}`` on card tensors from
    ``g`` against their plain versions: the forward (tile kernel, both
    occupancy flags exact: :func:`_product_err`), dX and dW within 2b's
    bound 2 K 2**-24 (|a| @ |b|); splitk_reduce bit-equal on the partial
    sums of each reduction whose length exceeds SPLIT_K.  Returns (the
    largest errors, the split-K shapes checked)."""
    import torch

    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.masked_matmul.backward import (
        masked_matmul_dw, masked_matmul_dw_reference, masked_matmul_dx,
        masked_matmul_dx_reference)
    from repro_torch.kernels.masked_matmul.ops import (split_k, splitk_reduce,
                                                       splitk_reduce_reference)

    dev = g.device
    errs = dict.fromkeys(("masked_matmul", "masked_matmul_dx", "masked_matmul_dw"), 0.0)
    splits = []

    def within(got, want, bnd, what) -> float:
        err = (got - want).abs_()
        if not bool((err <= bnd).all()):
            fail(f"{tag}: {what} off by {float(err.max()):.3g}")
        return float(err.max())

    for name, (m, k, n) in products.items():
        errs["masked_matmul"] = max(errs["masked_matmul"], _product_err(g, m, k, n, tag))
        x = quantize_nearest(torch.randn(m, k, generator=g, device=dev))
        w = quantize_nearest(torch.randn(k, n, generator=g, device=dev).div_(k**0.5))
        cot = torch.randn(m, n, generator=g, device=dev).mul_(1e-3)
        errs["masked_matmul_dx"] = max(errs["masked_matmul_dx"], within(
            masked_matmul_dx(cot, w), masked_matmul_dx_reference(cot, w),
            (cot.abs() @ w.abs().T).mul_(2 * n * 2.0**-24), f"{name} dx ({m},{n})@({n},{k})"))
        errs["masked_matmul_dw"] = max(errs["masked_matmul_dw"], within(
            masked_matmul_dw(x, cot), masked_matmul_dw_reference(x, cot),
            (x.abs().T @ cot.abs()).mul_(2 * m * 2.0**-24), f"{name} dw ({k},{m})@({m},{n})"))
        del x, w, cot
        # the split-K reductions of this product: forward K, dX's N, dW's M
        for red, rows, cols in ((k, m, n), (n, m, k), (m, k, n)):
            chunks = split_k(red)[1]
            if chunks > 1 and (chunks, rows, cols) not in splits:
                splits.append((chunks, rows, cols))
                part = quantize_nearest(torch.randn(chunks, rows, cols, generator=g, device=dev))
                if not torch.equal(splitk_reduce(part), splitk_reduce_reference(part)):
                    fail(f"{tag}: splitk_reduce {tuple(part.shape)} differs from its plain "
                         "version")
                del part
    return errs, splits


def _train_arch_kernel_checks(dev, arch: str, cfg, tokens: int) -> dict:
    """Each kernel of ``arch``'s train path on card tensors at the shapes
    the path gives it, against its plain version: the forward (tile kernel,
    both occupancy flags exact), dX and dW of each product within 2b's
    bound 2 K 2**-24 (|a| @ |b|); splitk_reduce bit-equal on the partial
    sums of each product whose K exceeds SPLIT_K; stochastic_round
    bit-equal at the embedding's (vocab, d_model), up to
    TRAIN_ARCHS_SR_ELEMS elements (its first rows); for mamba2 ssd_scan's y
    and state against the chunked plain version (rel 1e-4) and its
    autograd wrapper's gradients against autograd through the chunked
    form on the same card operands (rel 1e-5)."""
    import torch

    from repro_torch.kernels.stochastic_round.ops import sr_reference, stochastic_round

    g = torch.Generator(device=dev).manual_seed(16)
    d = cfg.d_model
    tag = f"{arch} train check"
    if arch == "whisper-medium":
        enc = TRAIN_ARCHS_BATCH * cfg.enc_seq
        products = {"enc qkvo": (enc, d, d), "enc mlp up": (enc, d, cfg.d_ff),
                    "enc mlp down": (enc, cfg.d_ff, d), "dec qkvo": (tokens, d, d),
                    "dec mlp up": (tokens, d, cfg.d_ff), "dec mlp down": (tokens, cfg.d_ff, d)}
    elif cfg.ssm is not None:
        s = cfg.ssm
        products = {"in_proj": (tokens, d, 2 * s.d_inner + 2 * s.n_groups * s.d_state
                                + s.n_heads), "out_proj": (tokens, s.d_inner, d)}
    else:
        products = {}
        kinds = {kind for _, _, kind in cfg.layer_plan}
        for mixer, ffn in kinds:
            if mixer in ("attn", "local"):
                a = cfg.attn if mixer == "attn" else cfg.local_attn
                products.update({f"{mixer} q": (tokens, d, a.n_heads * a.head_dim),
                                 f"{mixer} kv": (tokens, d, a.n_kv_heads * a.head_dim),
                                 f"{mixer} o": (tokens, a.n_heads * a.head_dim, d)})
            elif mixer == "mla":
                m = cfg.mla
                products.update({"mla wq": (tokens, d, m.n_heads * (m.qk_nope_dim
                                                                    + m.qk_rope_dim)),
                                 "mla wdkv": (tokens, d, m.kv_lora_rank),
                                 "mla wkr": (tokens, d, m.qk_rope_dim),
                                 "mla wo": (tokens, m.n_heads * m.v_head_dim, d)})
            elif mixer == "rglru":
                products.update({"rglru wx/wy": (tokens, d, cfg.rglru.d_rnn),
                                 "rglru wo": (tokens, cfg.rglru.d_rnn, d)})
            if ffn == "swiglu":
                products.update({"swiglu up": (tokens, d, cfg.d_ff),
                                 "swiglu down": (tokens, cfg.d_ff, d)})
            elif ffn == "moe":
                e = cfg.moe
                cap = max(int((tokens * e.top_k / e.n_experts) * e.capacity_factor + 0.999), 4)
                products.update({"expert up": (cap, d, e.d_ff), "expert down": (cap, e.d_ff, d)})
                if e.n_shared:
                    products.update({"shared up": (tokens, d, e.shared_d_ff * e.n_shared),
                                     "shared down": (tokens, e.shared_d_ff * e.n_shared, d)})
    errs, splits = _train_product_checks(g, products, tag)
    emb = torch.randn(min(cfg.vocab, TRAIN_ARCHS_SR_ELEMS // d), d, generator=g,
                      device=dev).mul_(0.02)
    if not torch.equal(stochastic_round(emb, 5), sr_reference(emb, 5)):
        fail(f"{tag}: stochastic_round {tuple(emb.shape)} differs from its plain version")
    sr_shape = tuple(emb.shape)
    del emb
    torch.cuda.empty_cache()
    if arch == "mamba2-780m":
        errs.update(_train_ssd_check(dev, cfg))
    torch.cuda.empty_cache()
    print(f"[train_archs] {arch} kernels at the path's shapes against their plain versions: "
          f"tile forward {errs['masked_matmul']:.3g}, dx {errs['masked_matmul_dx']:.3g}, dw "
          f"{errs['masked_matmul_dw']:.3g} over {[(k, v) for k, v in products.items()]}; "
          f"tile_occupancy exact; splitk_reduce bit-equal at {splits}; stochastic_round "
          f"{sr_shape} bit-equal", flush=True)
    return {"errs": errs, "products": products, "splitk": splits}


def _train_ssd_check(dev, cfg) -> dict:
    """ssd_scan at mamba2's training shapes (batch 8, S 128, its heads, head
    dim and state): the kernel's y and state against the chunked plain
    version (rel 1e-4, the registry's compare), and the autograd wrapper's
    gradients of a weighted sum of both against autograd through the
    chunked form on the same card operands (rel 1e-5)."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked, ssd_scan_trainable

    s = cfg.ssm
    g = torch.Generator(device=dev).manual_seed(17)
    shape = (TRAIN_ARCHS_BATCH, TRAIN_ARCHS_SEQ)
    x = torch.randn(*shape, s.n_heads, s.head_dim, generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(*shape, s.n_heads, generator=g, device=dev))
    a = -torch.exp(torch.randn(s.n_heads, generator=g, device=dev) * 0.5)
    b, c = (torch.randn(*shape, s.n_groups, s.d_state, generator=g, device=dev)
            .div_(s.d_state**0.5) for _ in range(2))
    gy = torch.randn(*shape, s.n_heads, s.head_dim, generator=g, device=dev)
    gs = torch.randn(shape[0], s.n_heads, s.d_state, s.head_dim, generator=g, device=dev)

    def rel(got, want) -> float:
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, a, b, c)]
        y, state = fn(*ins, return_state=True)
        return torch.autograd.grad((y * gy).sum() + (state * gs).sum(), ins)

    with torch.no_grad():
        y, state = ssd_scan(x, dt, a, b, c, return_state=True)
        want_y, want_state = ssd_scan_chunked(x, dt, a, b, c, return_state=True)
    fwd = max(rel(y, want_y), rel(state, want_state))
    grad = max(rel(got, w) for got, w in zip(run(ssd_scan_trainable), run(ssd_scan_chunked)))
    print(f"[train_archs] ssd_scan at {tuple(x.shape)}: y / state rel {fwd:.3g} against the "
          f"chunked plain version; the autograd wrapper's gradients rel {grad:.3g} against "
          "autograd through it", flush=True)
    if not (fwd <= 1e-4 and grad <= 1e-5):
        fail("train archs phase: ssd_scan or its autograd wrapper disagrees with the chunked "
             "plain version")
    return {"ssd_scan": fwd, "ssd_scan_grad": grad}


def _train_card_vs_cpu(dev, arch: str) -> dict:
    """The reduced ``arch``: lm_loss (encdec_loss with frames, a VLM's with
    its image prefix) and every gradient on the card against the CPU from
    the same weights and batch, quant_sparse with nearest rounding on
    Q16.60 (rounding is the identity there, so the card's fp32 sum order
    moves no value by a grid step): loss rel 1e-4, every gradient within
    DESIGN.md §8's contract, rtol 1e-5 with a floor of 1e-5 x (max + 1)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.models.layers import SpringContext
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime.train import (StepConfig, _loss_for, init_train_state,
                                           make_train_step)

    view = get_arch(arch).view(reduced=True)
    cfg = view.config
    spring = dataclasses.replace(QUANT_SPARSE, stochastic=False,
                                 fmt=FixedPointFormat(il=16, fl=60))
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 33), generator=gen)}
    if view.is_encdec:
        batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen)
    elif cfg.vlm_prefix_len:
        batch["img_embeds"] = torch.randn(2, cfg.vlm_prefix_len, cfg.d_model, generator=gen)
    step_cfg = StepConfig(spring=spring)
    params = init_train_state(view, step_cfg, 0, device="cpu").params
    out = {}
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.detach().clone().to(d).requires_grad_(True), params)
        loss, _ = _loss_for(view, cfg, p, {k: v.to(d) for k, v in batch.items()},
                            SpringContext(cfg=spring, attention="chunked"))
        grads = [gr.cpu() for gr in torch.autograd.grad(loss, tree_leaves(p))]
        _, m = make_train_step(view, step_cfg)(
            init_train_state(tree_map(lambda t: t.clone().to(d), params), step_cfg, 0),
            {k: v.to(d) for k, v in batch.items()})
        out[str(d)] = (float(loss.detach()), grads, float(m["loss"]))
    (l_c, g_c, s_c), (l_g, g_g, s_g) = out["cpu"], out[str(dev)]
    worst = 0.0
    for got, want in zip(g_g, g_c):
        floor = 1e-5 * (float(want.abs().max()) + 1.0)
        err = (got - want).abs()
        worst = max(worst, float((err / (want.abs() + float(want.abs().max()) + 1.0)).max()))
        if not bool((err <= floor + 1e-5 * want.abs()).all()):
            fail(f"train archs phase: reduced {arch}'s gradients on the card disagree with the "
                 "CPU's")
    rel = max(abs(l_g - l_c) / abs(l_c), abs(s_g - s_c) / abs(s_c))
    print(f"[train_archs] reduced {arch} card vs CPU (Q16.60, nearest): loss {l_g:.6f} vs "
          f"{l_c:.6f}, step loss {s_g:.6f} vs {s_c:.6f} (rel {rel:.3g}), worst gradient "
          f"{worst:.3g} of the contract's 1e-5 scale", flush=True)
    if rel > 1e-4:
        fail(f"train archs phase: reduced {arch}'s loss on the card disagrees with the CPU's")
    return {"loss_rel": rel, "grad_worst": worst}


def _routing(state, cfg, spring, batch) -> dict:
    """The experts' routing of one more forward of the trained model on
    ``batch``: the share of assignments dropped past their expert's
    capacity, and the aux load-balancing loss."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_hidden

    with moe_mod.record_routing() as rec, torch.no_grad():
        _, aux = lm_hidden(state.params, cfg, batch["tokens"],
                           SpringContext(cfg=spring, attention="chunked"))
    kept = sum(int(x["keep"].sum()) for x in rec)
    total = sum(x["keep"].numel() for x in rec)
    print(f"[train_archs] {cfg.name} routing after training: {total - kept} of {total} "
          f"assignments dropped ({1 - kept / total:.2%}), capacity {rec[0]['capacity']}, aux "
          f"loss {float(aux):.4f} summed over {len(rec)} MoE layers", flush=True)
    return {"dropped_share": 1 - kept / total, "assignments": total,
            "capacity": rec[0]["capacity"], "aux": float(aux)}


def phase_train_archs(dev) -> dict:
    """(5g) The rest of LM training at every width on the card (see
    5g in the module docstring): the launch counters are zeroed just
    before the first run and read just after the last; every kernel of
    TRAIN_ARCHS_KERNELS must launch in each part, splitk_reduce exactly in
    TRAIN_ARCHS_SPLITK's, ssd_scan in mamba2's (flash_attention never:
    training takes the chunked attention); then each part's path kernels
    against their plain versions at its shapes and each reduced arch on the
    card against the CPU."""
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.api import build_spec, threefry
    from repro_torch.api.sessions import synthetic_batch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.memstash.instrument import record_stash_traffic

    t_phase = time.monotonic()
    spec_path = str(ROOT / TRAIN_SPEC_FILE)
    bsz, seq = TRAIN_ARCHS_BATCH, TRAIN_ARCHS_SEQ
    parts, configs = {}, {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_archs_"))
    kernels.reset_launch_counts()
    try:
        parts["mamba2-780m"] = _train_mamba2(dev, tmp)
        configs["mamba2-780m"] = get_arch("mamba2-780m").config

        def resolved(arch, *sets):
            return build_spec("train", spec_file=spec_path, sets=[
                f"arch.id={arch}", "arch.reduced=false", "train.ckpt_dir=", *sets]).resolve()

        def lm_batches(vocab):
            stream = SyntheticLMStream(DataConfig(seed=0, vocab=vocab, seq_len=seq,
                                                  global_batch=bsz), device=dev)
            return lambda i: {"tokens": stream.batch(i)}

        for arch in ("olmoe-1b-7b", "deepseek-v2-lite-16b", "recurrentgemma-9b"):
            r = resolved(arch)
            cfg = configs[arch] = _cut(r.config, TRAIN_ARCHS_UNITS[arch])
            part = _train_part(dev, f"{arch} ({TRAIN_ARCHS_UNITS[arch]} of {r.config.n_units} "
                               f"units, {cfg.n_layers} layers)", get_arch(arch).view(config=cfg),
                               r.step, 3, lm_batches(cfg.vocab),
                               routing=None if cfg.moe is None else
                               lambda state, cfg=cfg, r=r: _routing(state, cfg, r.step.spring,
                                                                    lm_batches(cfg.vocab)(4)))
            part["units"], part["n_layers"] = TRAIN_ARCHS_UNITS[arch], cfg.n_layers
            parts[arch] = part
            if arch == "olmoe-1b-7b":
                # once more with the unit stashed: the stashed unit's aux loss
                r = resolved(arch, "memstash.policy=stash")
                scfg = _cut(r.config, TRAIN_ARCHS_UNITS[arch])
                # (not profiled: the remat run's profile stands for the part,
                # and a MoE step's trace takes some 20 s to read)
                with record_stash_traffic() as rows:
                    part = _train_part(dev, f"{arch} with the unit stashed ({scfg.n_layers} "
                                       "layers)", get_arch(arch).view(config=scfg), r.step, 3,
                                       lm_batches(scfg.vocab), profiled=False)
                part["stash_points"] = sum(1 for x in rows if x["layer"] == "lm/residual")
                if not part["stash_points"] or not all(a > 0 for a in part["aux"]):
                    fail("train archs phase: olmoe's stashed run stashed no unit or lost its "
                         "aux loss")
                parts[f"{arch} stash"] = part
                del rows

        # the train step's other branches: frames and an image prefix
        base = build_spec("train", spec_file=spec_path, sets=list(TRAIN_LM_SETS)).resolve()
        for arch, units in (("whisper-medium", None), ("internvl2-26b",
                                                       TRAIN_ARCHS_UNITS["internvl2-26b"])):
            full = get_arch(arch).config
            cfg = configs[arch] = full if units is None else _cut(full, units)
            view = get_arch(arch).view(config=cfg)
            t0 = time.monotonic()
            extra = {k: v.to(dev) for k, v in synthetic_batch(
                view, cfg, bsz, seq, threefry.prng_key(0)).items() if k != "tokens"}
            draw_s = time.monotonic() - t0
            tokens = lm_batches(cfg.vocab)

            def batches(i, extra=extra, tokens=tokens):
                return {**tokens(i), **extra}

            what = ("whole, 24 + 24 layers, frames" if units is None else
                    f"{units} of {full.n_units} layers, image prefix")
            part = _train_part(dev, f"{arch} ({what} {tuple(next(iter(extra.values())).shape)}"
                               f" drawn in {draw_s:.1f} s)", view, base.step, 2, batches)
            part["units"] = units
            parts[arch] = part
            del extra
        launches = kernels.launch_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    for tag, part in parts.items():
        arch = tag.split(" ")[0]
        need = (*TRAIN_ARCHS_KERNELS, *(("ssd_scan",) if arch == "mamba2-780m" else ()))
        for name in need:
            if part["launches"][name] <= 0:
                fail(f"train archs phase: {tag} never launched the {name} kernel")
        if (part["launches"]["splitk_reduce"] > 0) != (arch in TRAIN_ARCHS_SPLITK):
            fail(f"train archs phase: {tag} launched splitk_reduce "
                 f"{part['launches']['splitk_reduce']} times")
        if part["launches"]["flash_attention"]:
            fail(f"train archs phase: {tag} launched flash_attention (training takes the "
                 "chunked attention)")
    print(f"[train_archs] launches over the phase: {launches}", flush=True)

    t0 = time.monotonic()
    checks = {arch: _train_arch_kernel_checks(
        dev, arch, cfg, bsz * (seq + getattr(cfg, "vlm_prefix_len", 0)))
              for arch, cfg in configs.items()}
    card_cpu = {arch: _train_card_vs_cpu(dev, arch) for arch in configs}
    checks_s = time.monotonic() - t0
    wall = time.monotonic() - t_phase
    print(f"[train_archs] kernel and card-vs-CPU checks {checks_s:.1f} s; phase 5g wall "
          f"{wall:.1f} s", flush=True)
    errs = {k: max(c["errs"].get(k, 0.0) for c in checks.values())
            for k in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw")}
    return {"launches": launches, "parts": parts, "checks": checks, "card_vs_cpu": card_cpu,
            "errs": errs, "checks_s": checks_s, "wall_s": wall}


# -- slice 17: magnitude pruning and the lossy stash --------------------------------

# 5h: llama3.2-1b trained with StepConfig(prune_ratio=0.5) from the
# example train spec's numerics (batch 8, seq 128), then with eager
# pruning (apply_pruning after each update), served on phase 3's traffic
# with its weights pruned at every call; VGG-19 at 224², batch 32, with
# its conv and fc inputs stashed at capacity 0.6
PRUNE_RATIO = 0.5
PRUNE_STEPS = 3
EAGER = dict(final_sparsity=0.5, start_step=0, ramp_steps=2)
EAGER_STEPS = 4
STASH_CAPACITY = 0.6
PRUNE_TRAIN_KERNELS = ("masked_matmul", "tile_occupancy", "masked_matmul_dx",
                       "masked_matmul_dw", "stochastic_round")
PRUNE_SERVE_KERNELS = ("masked_matmul_skinny", "mask_pack", "flash_attention")


def _zero_shares(params: dict, cfg, ratio: float) -> dict:
    """Each dense projection's zero share as ``maybe_prune`` prunes it
    inline, the lowest and highest over the layers, by projection."""
    from repro_torch.models.layers import SpringContext

    prune = SpringContext(prune_ratio=ratio).maybe_prune
    out: dict = {}
    for layer in params["layers"]:
        for part in ("mixer", "ffn"):
            for name, p in layer[part].items():
                if isinstance(p, dict) and "kernel" in p:
                    share = float((prune(p["kernel"]) == 0).float().mean())
                    lo, hi = out.get(name, (1.0, 0.0))
                    out[name] = (min(lo, share), max(hi, share))
    return out


def _saved_bytes(model_fn, params: dict, ctx, x, y) -> tuple:
    """One CNN forward and loss with autograd's saved tensors counted (the
    backward is not run: its recomputes save tensors of their own):
    (the loss, bytes of the distinct storages the graph keeps for the
    backward pass, the stash points' rows)."""
    import torch

    from repro_torch.memstash.instrument import record_stash_traffic
    from repro_torch.models.cnn import ParamStore
    from repro_torch.runtime.train import cross_entropy

    seen: dict = {}

    def pack(t):
        # keep the storage, not the tensor: a hook that returned the tensor
        # itself would tie an output saved by its own node into a cycle the
        # collector cannot free (the graph is never run backward here); a
        # storage let go could be reused at its address and counted once
        st = t.untyped_storage()
        seen[st.data_ptr()] = st
        return st.nbytes()

    def unpack(_):
        raise RuntimeError("the counted graph is not for a backward pass")

    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, unpack), \
            record_stash_traffic() as rows:
        loss = cross_entropy(model_fn(ParamStore(0, p), ctx, x), y)
    torch.cuda.synchronize()
    return float(loss.detach()), sum(st.nbytes() for st in seen.values()), rows


def phase_prune_stash(dev, report: dict) -> dict:
    """(5h) Magnitude pruning and the lossy stash at full width on the
    card: the launch counters are zeroed just before each run and read
    just after; each path kernel is then held against its plain version
    at the run's shapes (the weights pruned as the path prunes them)."""
    import dataclasses
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.api import build_spec
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.core.spring_ops import QUANT_SPARSE, KeyGen
    from repro_torch.data.pipeline import DataConfig, SyntheticImageTask, SyntheticLMStream
    from repro_torch.kernels.masked_matmul.ops import record_tile_skip
    from repro_torch.launch.serve import serving_config
    from repro_torch.launch.train import MODELS, on_grid, run_arm
    from repro_torch.memstash import format as mfmt
    from repro_torch.memstash.config import STASH_ALL, MemstashConfig
    from repro_torch.memstash.report import measure_cnn_stash
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.pruning import (PruneSchedule, apply_pruning, measured_sparsity,
                                             quantile_f32)
    from repro_torch.runtime.train import TrainState, init_train_state, make_train_step
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    res: dict = {}
    launches: dict = {}

    def count(tag: str, before: dict) -> dict:
        got = {k: v - before.get(k, 0) for k, v in kernels.launch_counts().items()}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[prune] {tag} launches {got}", flush=True)
        return got

    # -- 1. pruned LM training through make_train_step -----------------------------
    spec = build_spec("train", spec_file=str(ROOT / TRAIN_SPEC_FILE), sets=list(TRAIN_LM_SETS))
    r = spec.resolve()
    cfg, view = r.config, get_arch("llama3.2-1b").view(config=r.config)
    bsz, seq = spec.shape.batch, spec.shape.seq
    stream = SyntheticLMStream(DataConfig(seed=0, vocab=cfg.vocab, seq_len=seq,
                                          global_batch=bsz), device=dev)

    def batch_at(i):
        return {"tokens": stream.batch(i)}

    pruned_cfg = dataclasses.replace(r.step, prune_ratio=PRUNE_RATIO)

    def inspect(state, step_fn):
        shares = _zero_shares(state.params, cfg, PRUNE_RATIO)
        with record_tile_skip() as skip:
            step_fn(state, batch_at(PRUNE_STEPS + 1))
        torch.cuda.synchronize()
        return {"zero_shares_trained": shares,
                "tile_skip": {op: 1.0 - v[0] / v[1] for op, v in skip.items() if v[1]}}

    # the weights are Gaussian at init: there each share is the ratio
    init = lm_init(cfg, 0, device=dev)
    init_shares = _zero_shares(init, cfg, PRUNE_RATIO)
    del init
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    part = _train_part(dev, f"llama3.2-1b pruned {PRUNE_RATIO} (batch {bsz}, seq {seq})", view,
                       pruned_cfg, PRUNE_STEPS, batch_at, phase="prune", inspect=inspect)
    # the inspect step's launches are the path's too
    part["launches"] = count("pruned train", {})
    trained, skip = part["inspect"]["zero_shares_trained"], part["inspect"]["tile_skip"]
    part["inspect"]["zero_shares_init"] = init_shares

    def fmt(sh):
        return {k: (round(a, 4), round(b, 4)) for k, (a, b) in sh.items()}

    print(f"[prune] pruned projections' zero shares (min, max over layers) at init "
          f"{fmt(init_shares)}, after {PRUNE_STEPS + 1} steps {fmt(trained)}; measured tile "
          f"skip { {k: round(v, 6) for k, v in skip.items()} }", flush=True)
    if not all(abs(a - PRUNE_RATIO) <= 0.02 and abs(b - PRUNE_RATIO) <= 0.02
               for a, b in init_shares.values()):
        fail("prune phase: a pruned projection's zero share is not within 0.02 of the ratio")
    for name in PRUNE_TRAIN_KERNELS:
        if part["launches"][name] <= 0:
            fail(f"prune phase: the pruned train step never launched the {name} kernel")
    res["train"] = part
    res["train_checks"] = _train_lm_kernel_checks(dev, cfg, bsz, seq, PRUNE_RATIO, "prune")
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2. eager pruning: apply_pruning after each update --------------------------
    kernels.reset_launch_counts()
    sched = PruneSchedule(**EAGER)
    state = init_train_state(view, r.step, 0, device=dev)
    step_fn = make_train_step(view, r.step)
    prune_ms, losses = [], []
    emb_n = state.params["embed"]["embedding"].numel()
    for i in range(EAGER_STEPS):
        state, m = step_fn(state, batch_at(i))
        losses.append(float(m["loss"]))
        if i == EAGER_STEPS - 1:  # the last threshold is checked on this embedding
            emb = state.params["embed"]["embedding"].clone()
        torch.cuda.synchronize()
        t = time.monotonic()
        params = apply_pruning(state.params, i, sched, cfg=cfg)
        torch.cuda.synchronize()
        prune_ms.append((time.monotonic() - t) * 1e3)
        state = TrainState(params, state.opt_state, state.step, state.seed)
        del params
    sp = float(measured_sparsity(state.params, cfg=cfg))
    s_end = float(sched.sparsity_at(EAGER_STEPS - 1))
    # the threshold's rank in the embedding it pruned: a quantile past 2**24
    # elements, its index q (n - 1) rounded in fp32 (an error of at most 16
    # elements here); the zeros are exactly the entries at or under it
    mag = emb.abs_()
    t = quantile_f32(mag, s_end)
    below, upto = float((mag < t).double().mean()), float((mag <= t).double().mean())
    zeros = int((state.params["embed"]["embedding"] == 0).sum())
    exact = zeros == int((mag <= t).sum())
    grid = on_grid(dict(enumerate(tree_leaves(state.params))))
    eager = {"losses": losses, "apply_pruning_ms": prune_ms, "measured_sparsity": sp,
             "final_target": s_end, "embedding_elems": emb_n, "embedding_zero_share": zeros / emb_n,
             "embedding_under_threshold": below, "embedding_at_or_under": upto,
             "zeros_are_those_at_or_under": exact, "on_grid": grid,
             "launches": count("eager pruning", {})}
    print(f"[prune] eager pruning {EAGER} over {EAGER_STEPS} steps: losses "
          f"{[round(v, 4) for v in losses]}, apply_pruning {[round(v, 1) for v in prune_ms]} ms "
          f"a call, measured sparsity {sp:.4f} (target {s_end:.4f}), the {emb_n:,}-element "
          f"embedding: {below:.8f} under its last threshold, {upto:.8f} at or under, its zeros "
          f"exactly those {exact}; on grid {grid}", flush=True)
    del state, step_fn, emb, mag, t
    if not (0.4 < sp < 0.6 and all(math.isfinite(v) for v in losses) and grid):
        fail(f"prune phase: eager pruning's sparsity {sp:.4f} is outside (0.4, 0.6), a loss is "
             "not finite or a parameter left the grid")
    if not (emb_n > 2**24 and exact and below <= s_end + 1e-7 and upto >= s_end - 1e-7):
        fail("prune phase: the embedding's threshold is not its s-quantile")
    res["eager"] = eager
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. pruned serving: phase 3's traffic ---------------------------------------
    scfg = get_arch("llama3.2-1b").resolve(False)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    eng = ServingEngine(scfg, serving_config("quant_sparse"), n_slots=SLOTS,
                        max_len=PROMPT + GEN + 1, seed=0, device=dev, prune_ratio=PRUNE_RATIO)
    for i, prompt in enumerate(synthetic_prompts(REQUESTS, REQUESTS, PROMPT, scfg.vocab, 0)):
        eng.submit_prompt(prompt, GEN, seed=i)
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    del eng
    serve_launches = count("pruned serve", {})
    done = [q for q in out["per_request"] if q["n_tokens"] == GEN]
    base = report.get("serve", {}).get("tokens_per_s", float("nan"))
    print(f"[prune] pruned serve llama3.2-1b {SLOTS} slots: {len(done)}/{REQUESTS} requests, "
          f"finite={out['finite']}, tokens/s {out['tokens_per_s']:.2f} (unpruned phase 3: "
          f"{base:.2f}), wall {wall:.1f} s", flush=True)
    if len(done) != REQUESTS or not out["finite"]:
        fail("prune phase: the pruned serve did not finish every request with finite logits")
    for name in PRUNE_SERVE_KERNELS:
        if serve_launches[name] <= 0:
            fail(f"prune phase: the pruned serve never launched the {name} kernel")
    prof = profile_decode(dev, prune_ratio=PRUNE_RATIO)
    base = report.get("decode_profile", {"tick_ms": float("nan"),
                                         "device_busy_ms": float("nan")})
    print(f"[prune] a decode tick: pruned {prof['tick_ms']:.2f} ms wall, "
          f"{prof['device_busy_ms']:.2f} device; unpruned (3b) {base['tick_ms']:.2f} wall, "
          f"{base['device_busy_ms']:.2f} device", flush=True)
    res["serve"] = {"tokens_per_s": out["tokens_per_s"], "wall_s": wall,
                    "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
                    "launches": serve_launches, "profile": prof,
                    "tokens": [q["tokens"] for q in out["per_request"]]}
    res["serve_checks"] = _arch_kernel_checks(
        dev, scfg, 17, prompt=PROMPT, decode_m=SLOTS, tag="prune",
        kv_blocks=((SLOTS, (PROMPT + GEN + 1) * KV_ROW),), prune_ratio=PRUNE_RATIO)
    # the reduced model, card against CPU: the same greedy tokens
    rcfg = get_arch("llama3.2-1b").resolve(True)
    params = lm_init(rcfg, 3, device="cpu")
    prompts = synthetic_prompts(REQUESTS, REQUESTS, 12, rcfg.vocab, 1)
    toks = {}
    for d in ("cpu", dev):
        e = ServingEngine(rcfg, serving_config("quant_sparse"), n_slots=SLOTS, max_len=40,
                          seed=0, device=d, prune_ratio=PRUNE_RATIO,
                          params=_to(params, d) if d != "cpu" else params)
        for i, prompt in enumerate(prompts):
            e.submit_prompt(prompt, 8, seed=i)
        toks[str(d)] = [q["tokens"] for q in e.run()["per_request"]]
    same = toks["cpu"] == toks[str(dev)]
    print(f"[prune] reduced llama3.2-1b pruned, card vs CPU: greedy tokens equal {same}",
          flush=True)
    if not same:
        fail("prune phase: the reduced pruned model's tokens on the card differ from the CPU's")
    res["reduced_tokens_equal"] = same
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. the lossy stash: VGG-19 at capacity 0.6 ---------------------------------
    lossy = MemstashConfig(policy="stash", capacity=STASH_CAPACITY)
    kernels.reset_launch_counts()
    out = run_arm("vgg19-lossy", "vgg19", "quant_sparse", True, VGG_STEPS, VGG_HW, VGG_BATCH,
                  dev, lossy, seed=0, verbose=False)
    vgg_launches = count("lossy stash", {})
    print(f"[prune] vgg19 stash capacity {STASH_CAPACITY}: losses "
          f"{[round(v, 4) for v in out['losses']]}, on grid {out['on_grid']}, "
          f"{out['s_per_step']:.3f} s/step, peak {out['peak_mem_bytes'] / 2**30:.2f} GiB "
          f"(capacity 1.0, 5c: "
          f"{report.get('train', {}).get('run', {}).get('peak_mem_bytes', math.nan) / 2**30:.2f})",
          flush=True)
    if not (out["finite"] and all(out["on_grid"]) and len(out["on_grid"]) == VGG_STEPS):
        fail("prune phase: a lossy-stash loss is not finite or a parameter left the grid")
    for name in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "stochastic_round"):
        if vgg_launches[name] <= 0:
            fail(f"prune phase: the lossy-stash run never launched the {name} kernel")
    # one more step at each capacity: the saved storages and each point's record
    data = SyntheticImageTask(DataConfig(seed=0, global_batch=VGG_BATCH), hw=VGG_HW, device=dev)
    x, y = data.batch(VGG_STEPS)
    per_cap = {}
    for cap, scfg_ in ((1.0, STASH_ALL), (STASH_CAPACITY, lossy)):
        ctx = SpringContext(cfg=QUANT_SPARSE, keys=KeyGen(1), memstash=scfg_)
        loss, saved, rows = _saved_bytes(MODELS["vgg19"].fn, out["params"], ctx, x, y)
        # each point's value buffer: ceil(n * capacity) fp32 values
        values = sum(4 * (q["elems"] if cap >= 1.0 else math.ceil(q["elems"] * cap))
                     for q in rows)
        per_cap[cap] = {"saved_bytes": saved, "value_buffer_bytes": values, "loss": loss,
                        "overflow": {q["layer"]: q["overflow"] for q in rows},
                        "density": {q["layer"]: round(q["density"], 4) for q in rows}}
        del rows
        torch.cuda.empty_cache()
    full, part_ = per_cap[1.0], per_cap[STASH_CAPACITY]
    print(f"[prune] stashed value buffers {full['value_buffer_bytes'] / 2**30:.3f} GiB at 1.0, "
          f"{part_['value_buffer_bytes'] / 2**30:.3f} GiB at {STASH_CAPACITY}; autograd's saved "
          f"storages {full['saved_bytes'] / 2**30:.3f} / {part_['saved_bytes'] / 2**30:.3f} "
          f"GiB (a forward's graph); overflow per point at {STASH_CAPACITY}: "
          f"{part_['overflow']}", flush=True)
    # a capacity-1.0 record through the new signature is the exact record's bits
    # density 0.75 (a ReLU of N(0.6745, 1)): the 0.6 buffer overflows
    act = torch.relu(torch.randn(VGG_BATCH, VGG_HW, VGG_HW, 64, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev).add_(0.6745))
    a, b = mfmt.compress(act), mfmt.compress(act, capacity=1.0)
    c = mfmt.compress(act, capacity=STASH_CAPACITY)
    exact = all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("values", "mask", "nnz"))
    back = mfmt.decompress(c)
    prefix = int(c.capacity_len)
    lossy_ok = (torch.equal(c.values, a.values[:prefix]) and torch.equal(c.mask, a.mask)
                and int(c.overflow) == max(0, int(a.nnz) - prefix)
                and torch.equal(back.reshape(-1) != 0,
                                (act.reshape(-1) != 0) & (torch.cumsum(
                                    (act.reshape(-1) != 0).to(torch.int64), 0) <= prefix)))
    print(f"[prune] compress at capacity 1.0 bit-equal to the exact record {exact}; at "
          f"{STASH_CAPACITY} the first {prefix:,} values and the mask equal, overflow "
          f"{int(c.overflow):,} decoded as zero {lossy_ok}", flush=True)
    overflow = int(c.overflow)
    del act, a, b, c, back
    if not (exact and lossy_ok and overflow > 0):
        fail("prune phase: a stash record differs from the exact record where it must not")
    rep = {}
    for cap, scfg_ in ((1.0, STASH_ALL), (STASH_CAPACITY, lossy)):
        rs = measure_cnn_stash("vgg19", hw=VGG_HW, batch=VGG_BATCH, scfg=scfg_, device=dev)
        sm = rs["summary"]
        rep[cap] = {k: sm[k] for k in ("stash_points", "mean_density", "dense_fp32_bytes",
                                       "wire_bytes", "formula_bytes", "compression_vs_fp32",
                                       "wire_vs_formula")}
        rep[cap]["overflow"] = sum(q["overflow"] for q in rs["rows"])
        print(f"[prune] measure_cnn_stash vgg19 {VGG_HW}² batch {VGG_BATCH} capacity {cap}: "
              f"{sm['stash_points']} points, density {sm['mean_density']:.4f}, wire "
              f"{sm['wire_bytes'] / 1e6:.2f} MB, wire / formula {sm['wire_vs_formula']:.4f}, "
              f"{sm['compression_vs_fp32']:.3f}x against fp32", flush=True)
        del rs
    res["stash"] = {"run": {k: v for k, v in out.items() if k != "params"},
                    "launches": vgg_launches, "per_capacity": per_cap, "report": rep,
                    "record_exact": exact, "record_lossy_ok": lossy_ok}
    del out
    gc.collect()
    torch.cuda.empty_cache()
    res["launches"] = launches
    res["wall_s"] = time.monotonic() - t_phase
    res["left_allocated_bytes"] = torch.cuda.memory_allocated(dev) - held
    print(f"[prune] launches over the phase {launches}; phase 5h wall {res['wall_s']:.1f} s; "
          f"{res['left_allocated_bytes'] / 2**20:.1f} MiB more allocated than at its start",
          flush=True)
    return res


# -- slice 3: long-prompt prefill and Mamba-2 serving -----------------------------

# llama3.2-1b's attention (H 32, HKV 8, D 64) at prefill lengths; the long
# serve; mamba2-780m's SSD (H 48, P 64, N 128, G 1) and its serve
FA_HEADS, FA_KV_HEADS, FA_DIM = 32, 8, 64
# 6a's timed (S, D) rows at B 1, H 32, HKV 8, causal, fp32: llama3.2-1b's
# prefills (S 32 and 128 as in the prompt-32 serve, up to S 8192), and head
# dim 128 (minitron-4b's and mistral-nemo-12b's) at S 4096
FA_ROWS = ((32, 64), (128, 64), (512, 64), (4096, 64), (8192, 64), (4096, 128))
LONG_SLOTS, LONG_REQUESTS, LONG_PROMPT = 4, 4, 4096
SSD_HEADS, SSD_DIM, SSD_STATE, SSD_CHUNK = 48, 64, 128, 128
MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_PROMPT = 4, 6, 2000
MAMBA_LATE = 2  # requests with an admission deadline of 0 ticks, shed behind the full pool
CHECK_PROMPT = 300
LONG_KERNELS = ("flash_attention", "masked_matmul", "tile_occupancy", "mask_pack")
MAMBA_KERNELS = ("ssd_scan", "masked_matmul", "tile_occupancy")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def phase_flash_attention(dev, gen) -> dict:
    """(6a) flash_attention against its plain version on the reference
    registry's examples (``flash_attention/ops.py:39-55``, its compare:
    fp32 atol 2e-5, bf16 atol 2e-2) and a non-causal ragged case, then at
    the :data:`FA_ROWS` shapes, q/k/v as ``gqa_apply`` passes them
    (transposed (B, S, H, D) projections): each row's query tile, its call
    time (a timed loop), device time with L2 flushed and host time, beside
    the plain version, fp32 scaled_dot_product_attention and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention, plan

    def qkv(b, h, hkv, s, d, dtype=torch.float32):
        return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                     for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))

    cases = [("causal (2,4,2,256,64)", qkv(2, 4, 2, 256, 64), {"causal": True}, 2e-5),
             ("ragged (1,4,1,300,64)", qkv(1, 4, 1, 300, 64), {"causal": True}, 2e-5),
             ("window 128 (2,2,2,256,64)", qkv(2, 2, 2, 256, 64),
              {"causal": True, "window": 128}, 2e-5),
             ("non-causal (1,8,4,384,128)", qkv(1, 8, 4, 384, 128), {"causal": False}, 2e-5),
             ("bf16 (1,2,2,128,64)", qkv(1, 2, 2, 128, 64, torch.bfloat16), {}, 2e-2),
             ("non-causal ragged (1,4,2,200,64)", qkv(1, 4, 2, 200, 64), {"causal": False}, 2e-5)]
    err, case_errs = 0.0, {}
    for name, (q, k, v), kw, atol in cases:
        e = _max_err(flash_attention(q, k, v, **kw), attention_reference(q, k, v, **kw))
        err, case_errs[name] = max(err, e), e
        print(f"[flash_attention] {name} {kw}: max_abs_err {e:.3g} (atol {atol:g})", flush=True)
        if not e <= atol:
            fail(f"flash_attention {name} disagrees with its plain version")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for s, d in FA_ROWS:
        q = torch.randn(1, s, FA_HEADS, d, generator=gen).to(dev).transpose(1, 2)
        k, v = (torch.randn(1, s, FA_KV_HEADS, d, generator=gen).to(dev).transpose(1, 2)
                for _ in range(2))
        tile = plan(1, FA_HEADS, FA_KV_HEADS, s, d, n_sms)

        def kernel():
            return flash_attention(q, k, v)

        def lib():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        want = attention_reference(q, k, v)
        e, lib_e = _max_err(kernel(), want), _max_err(lib(), want)
        del want
        err, case_errs[f"llama prefill S={s} D={d}"] = max(err, e), e
        if not e <= 2e-5:
            fail(f"flash_attention at S={s} D={d} off by {e:.3g}")
        iters = 200 if s <= 512 else 20 if s * d <= 4096 * 128 else 5
        ms, dev_ms = timed(kernel, iters), cold_device_ms(kernel)
        host = host_ms(kernel, iters=50, warmup=5)
        plain_ms = timed(lambda: attention_reference(q, k, v), 2, warmup=1)
        lib_ms, lib_dev_ms = timed(lib, iters), cold_device_ms(lib)
        torch.cuda.empty_cache()
        pairs = s * (s + 1) / 2  # live (query, key) pairs under the causal mask
        flops = 4.0 * FA_HEADS * pairs * d
        b_ms, b_by = bound(4.0 * 2 * s * d * (FA_HEADS + FA_KV_HEADS), flops)
        rows.append({"seq": s, "head_dim": d, "tile": tile._asdict(), "ms": ms,
                     "device_ms": dev_ms, "host_ms": host, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": e, "library_max_abs_err": lib_e,
                     "tflops": flops / ms / 1e9, "device_tflops": flops / dev_ms / 1e9})
        print(f"[flash_attention] llama prefill B1 H{FA_HEADS} HKV{FA_KV_HEADS} D{d} S{s} "
              f"causal fp32, tile {tile.rows} rows = {tile.heads_per_cta} heads x "
              f"{tile.positions} positions, {tile.ctas} CTAs: err {e:.3g}; kernel {ms:.4f} ms "
              f"({rows[-1]['tflops']:.2f} TFLOP/s), device {dev_ms:.4f} ms with L2 flushed, "
              f"host {host:.4f} ms; plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
              f"(device {lib_dev_ms:.4f}, err {lib_e:.3g}), bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del q, k, v
    return {"rows": rows, "err": err, "case_errs": case_errs}


def phase_ssd_scan(dev, gen) -> dict:
    """(6b) ssd_scan against its chunked plain version (y and the final
    state, rel 1e-4: the registry's compare, ``ssd_scan/ops.py:126-127``)
    on the registry's three examples (``ops.py:112-123``) and at
    mamba2-780m's prefill shape, x / b / c read as views of one projection
    as ``ssm_apply`` splits them; each of the four stage kernels against its
    plain stage there (rel 1e-4, fed the plain outputs of the stages before
    it); timed, each stage beside the total, the plain version and the
    bound; and, not gated, the deviation of the kernel and of the chunked
    plain version from a float64 run of the sequential oracle at the model's
    decays.  No single PyTorch call computes the scan."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked, ssd_scan_reference

    def rel(got, want) -> float:
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def check(name, args) -> float:
        (y, st), (wy, wst) = (ssd_scan(*args, return_state=True),
                              ssd_scan_chunked(*args, return_state=True))
        r = max(rel(y, wy), rel(st, wst))
        e = max(_max_err(y, wy), _max_err(st, wst))
        print(f"[ssd_scan] {name}: y and state rel err {r:.3g} (rel 1e-4), max_abs_err "
              f"{e:.3g}", flush=True)
        if not r <= 1e-4:
            fail(f"ssd_scan {name} disagrees with its plain version")
        return e

    def decay_inputs(bsz, s, h):
        dt = F.softplus(torch.randn(bsz, s, h, generator=gen))
        return dt.to(dev), (-torch.exp(torch.randn(h, generator=gen) * 0.5)).to(dev)

    err = 0.0
    for bsz, s, h, p, g, n in ((2, 320, 4, 64, 2, 32), (1, 128, 2, 32, 1, 16),
                               (1, 96, 2, 32, 1, 16)):
        x = torch.randn(bsz, s, h, p, generator=gen).to(dev)
        dt, a = decay_inputs(bsz, s, h)
        b, c = ((torch.randn(bsz, s, g, n, generator=gen) / n**0.5).to(dev) for _ in range(2))
        err = max(err, check(f"({bsz},{s},{h},{p}) g{g} n{n}", (x, dt, a, b, c)))
    s, h, p, n = MAMBA_PROMPT, SSD_HEADS, SSD_DIM, SSD_STATE
    xbc = torch.randn(1, s, h * p + 2 * n, generator=gen)
    xbc[..., h * p:] /= n**0.5
    xbc = xbc.to(dev)
    x = xbc[..., :h * p].reshape(1, s, h, p)
    b = xbc[..., h * p:h * p + n].reshape(1, s, 1, n)
    c = xbc[..., h * p + n:].reshape(1, s, 1, n)
    dt, a = decay_inputs(1, s, h)
    args = (x, dt, a, b, c)
    err = max(err, check(f"mamba2-780m prefill x {tuple(x.shape)} b/c {tuple(b.shape)}", args))
    # the model's own decays: ssm_init's a = -linspace(1, 16) and dt =
    # softplus(dt_raw + 0), so cumulative log decays reach about -2000 per chunk
    model_dt = F.softplus(torch.randn(1, s, h, generator=gen)).to(dev)
    model_a = -torch.linspace(1.0, 16.0, h, device=dev)
    model_args = (x, model_dt, model_a, b, c)
    err = max(err, check("mamba2-780m prefill, the model's decays a = -linspace(1, 16)",
                         model_args))

    # each stage kernel's launcher, on the operands ssd_scan checks and
    # hands it, against its plain stage fed the plain outputs of the stages
    # before it (the fp32 workspaces made contiguous, as the kernels write
    # them), at the prefill shape
    ops._check_cuda(x, dt, a, b, c)
    xr, dtr, br, cr = ops._rows(x, dt, b, c)
    cb = ref.ssd_chunk_scores(br, cr).contiguous()
    st, cum = (t.contiguous() for t in ref.ssd_chunk_state(xr, dtr, a, br))
    h_prev, final = (t.contiguous() for t in ref.ssd_state_passing(st, cum))
    stages = {"chunk_scores": (lambda: ops._scores(br, cr), cb),
              "chunk_state": (lambda: ops._state(xr, dtr, a, br), (st, cum)),
              "state_passing": (lambda: ops._passing(st, cum), (h_prev, final)),
              "chunk_scan": (lambda: ops._scan(xr, dtr, cr, cb, cum, h_prev),
                             ref.ssd_chunk_scan(xr, dtr, cr, cb, cum, h_prev))}
    stage_rows = {}
    for name, (fn, want) in stages.items():
        got = fn()
        pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
        r = max(rel(g_, w_) for g_, w_ in pairs)
        e = max(_max_err(g_, w_) for g_, w_ in pairs)
        err = max(err, e)
        print(f"[ssd_scan] stage {name}: rel err {r:.3g} (rel 1e-4) against its plain stage",
              flush=True)
        if not r <= 1e-4:
            fail(f"ssd_scan stage {name} disagrees with its plain stage")
        stage_rows[name] = {"rel_err": r, "max_abs_err": e,
                            "device_ms": cold_device_ms(fn)}
    del cb, st, cum, h_prev, final, stages

    ms = timed(lambda: ssd_scan(*args, return_state=True), 20)
    dev_ms = cold_device_ms(lambda: ssd_scan(*args, return_state=True))
    plain_ms = timed(lambda: ssd_scan_chunked(*args, return_state=True), 5, warmup=1)
    nc = -(-s // SSD_CHUNK)
    # live (t, j <= t) pairs over the S real steps; C·B^T once for the one
    # group, and per head the masked scores @ x, the chunk state and C @ h_prev
    pairs = sum(l * (l + 1) / 2 for l in (min(SSD_CHUNK, s - i) for i in range(0, s, SSD_CHUNK)))
    flops = 2.0 * (pairs * n + h * (pairs * p + 2 * s * n * p))
    nbytes = 4.0 * (2 * s * h * p + 2 * s * n + s * h + h + h * n * p)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[ssd_scan] mamba2-780m prefill: kernel {ms:.4f} ms a call, {dev_ms:.4f} ms of "
          f"device time with L2 flushed ({flops / ms / 1e9:.2f} TFLOP/s a call; stages' device "
          "ms " + ", ".join(f"{k} {v['device_ms']:.4f}" for k, v in stage_rows.items())
          + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)

    # which drifts from the recurrence: the kernel or the chunked plain
    # version, against a float64 run of the sequential oracle (not gated)
    y64 = ssd_scan_reference(*(t.double() for t in model_args))
    drift = {"kernel": rel(ssd_scan(*model_args), y64),
             "ssd_scan_chunked": rel(ssd_scan_chunked(*model_args), y64)}
    del y64
    print(f"[ssd_scan] the model's decays against the float64 sequential oracle: kernel rel "
          f"{drift['kernel']:.3g}, ssd_scan_chunked rel {drift['ssd_scan_chunked']:.3g} "
          f"(printed, not gated)", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "stages": stage_rows,
            "float64_oracle_rel": drift,
            "shape": f"x {tuple(x.shape)}, b/c {tuple(b.shape)}, {nc} chunks, with the final "
                     "state"}


def phase_serve(dev, arch: str, slots: int, requests: int, prompt: int, needed: tuple,
                tag: str, late: int = 0) -> dict:
    """(6c/6d) full-width ``arch`` served in quant_sparse, gen GEN, through
    ``serve_session``; the counters are zeroed just before and read just
    after, and every kernel in ``needed`` must have launched.  ``late``
    more requests with an admission deadline of 0 ticks queue behind the
    full pool: each must be shed with ``"deadline"`` and no tokens."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.launch.serve import serve_session, serving_config
    from repro_torch.serving.engine import ServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    if late:
        # the session's engine body (api/sessions.py), whose spec gives
        # every request one deadline, with the late requests submitted
        # after its own
        cfg = get_arch(arch).resolve(False)
        engine = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=slots,
                               max_len=prompt + GEN + 1, seed=0, device=dev)
        n = requests + late
        for i, p in enumerate(synthetic_prompts(n, n, prompt, cfg.vocab, 0)):
            engine.submit_prompt(p, GEN, seed=i, deadline_ticks=0 if i >= requests else None)
        out = engine.run()
    else:
        out = serve_session(arch, reduced=False, mode="quant_sparse", slots=slots,
                            queue=requests, prompt_len=prompt, gen=GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    served, shed = out["per_request"][:requests], out["per_request"][requests:]
    done = [r for r in served if r["n_tokens"] == GEN]
    print(f"[{tag}] {arch} quant_sparse {slots} slots, prompt {prompt}: {len(done)}/{requests} "
          f"requests with {GEN} tokens, finite={out['finite']}, prefill "
          f"{out['prefill_s'] / requests:.3f} s per request, tokens_per_s="
          f"{out['tokens_per_s']:.2f}, decode_s={out['decode_s']:.3f}, decode_steps="
          f"{out['decode_steps']}, peak {peak / 2**30:.2f} GiB, wall {wall:.1f}s", flush=True)
    print(f"[{tag}] launches {launches}", flush=True)
    if len(done) != requests or not out["finite"]:
        fail(f"{tag} phase: not every request finished with finite logits")
    if late:
        print(f"[{tag}] {late} requests with deadline_ticks=0 behind the full pool: "
              f"{[(r['rid'], r['rejected'], r['n_tokens']) for r in shed]}, "
              f"{out['elastic']}", flush=True)
        if any(r["rejected"] != "deadline" or r["tokens"] for r in shed) \
                or out["elastic"]["n_rejected"] != late:
            fail(f"{tag} phase: the late requests were not shed with 'deadline' and no tokens")
    for name in needed:
        if launches[name] <= 0:
            fail(f"{tag} phase never launched the {name} kernel")
    # the tokens are kept below, once; "generated" is the session's array of them
    res = {k: v for k, v in out.items() if k not in ("per_request", "generated")}
    res.update(tokens=[r["tokens"] for r in out["per_request"]], launches=launches,
               peak_mem_bytes=peak, wall_s=wall,
               prefill_s_per_request=out["prefill_s"] / requests)
    return res


# 3c: the example serve spec, run by the port's launcher as a user would,
# at full width on the card.  The spec's prompt is 32, where every product
# has M <= 32 and takes the skinny kernel; prompt 64 puts each prefill on
# the tile kernel and its occupancy pre-pass as well
SPEC_FILE = "examples/specs/serve_quant_sparse.json"
SPEC_SETS = ("arch.reduced=false", "kernels.policy=auto", "shape.prompt_len=64")
SPEC_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "mask_pack",
                "flash_attention")
SPEC_TIMEOUT_S = 300


def phase_spec(dev) -> dict:
    """(3c) the spec-driven launcher: ``python -m repro_torch.launch.serve
    --spec SPEC_FILE --set ...`` as subprocesses on the card.  The run
    must exit 0 with the ``spec_hash`` of the in-process ``build_spec`` of
    the same layers, and its tokens must equal an in-process
    ``ServeSession`` over that spec, whose launch counters are zeroed just
    before and read just after (every kernel of SPEC_KERNELS, the tile
    kernel among them, must launch); a run with ``serving.snapshot_every=3``
    and then ``serving.restore_path`` drains the same tokens, and so does
    ``serving.pages=true``; ``kernels.policy=ref`` must exit non-zero with
    the SpecError.  The snapshot, paged and refused runs share the card at
    once; the timed run and the in-process session run alone.  Then each
    kernel of the path against its plain version at the shapes it gives
    them (decode M = the spec's 2 slots, prefill M = 64, the pool's leaves)."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from repro_torch import kernels
    from repro_torch.api import ServeSession, build_spec
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import CLI_BASE

    t_phase = time.monotonic()
    spec_path = str(ROOT / SPEC_FILE)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_spec_"))
    sets = [arg for item in SPEC_SETS for arg in ("--set", item)]

    def launcher(name: str, *extra: str) -> tuple:
        argv = [sys.executable, "-m", "repro_torch.launch.serve", "--spec", spec_path,
                *sets, *extra, "--json", str(tmp / f"{name}.json")]
        t0 = time.monotonic()
        p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=SPEC_TIMEOUT_S)
        return name, p, time.monotonic() - t0

    def result(run: tuple) -> dict:
        name, p, wall = run
        if p.returncode != 0:
            fail(f"spec phase: the {name} launcher run exited {p.returncode}:\n"
                 f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
        out = json.loads((tmp / f"{name}.json").read_text())
        out["wall_s"] = wall
        print(f"[spec] {name}: {p.stdout.strip().splitlines()[0]} (wall {wall:.1f} s)",
              flush=True)
        return out

    def tokens(out: dict) -> list:
        return [r["tokens"] for r in out["per_request"]]

    try:
        main_out = result(launcher("main"))
        # the launcher's layers: its base, the file, then the --set items
        spec = build_spec("serve", data=CLI_BASE, data_label="launcher-default",
                          spec_file=spec_path, sets=list(SPEC_SETS))
        want_hash = spec.spec_hash()
        n_req = len(main_out["per_request"])
        print(f"[spec] launcher at full width: {n_req} requests over {main_out['slots']} slots, "
              f"prefill {main_out['prefill_s'] / n_req:.4f} s per request, "
              f"{main_out['tokens_per_s']:.2f} tokens/s, decode_s {main_out['decode_s']:.3f}, "
              f"wall {main_out['wall_s']:.1f} s; spec_hash {main_out['spec_hash']} "
              f"(in process {want_hash})", flush=True)
        if main_out["spec_hash"] != want_hash:
            fail("spec phase: the launcher's spec_hash differs from build_spec of its layers")
        if not main_out["finite"] or any(len(t) != spec.shape.gen for t in tokens(main_out)):
            fail("spec phase: the launcher did not finish every request with finite logits")

        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        inproc = ServeSession(spec, device=dev).run()
        torch.cuda.synchronize()
        inproc_wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        tile = launches["masked_matmul"] - launches["masked_matmul_skinny"]
        print(f"[spec] in-process ServeSession: tokens equal the launcher's "
              f"{tokens(inproc) == tokens(main_out)}, wall {inproc_wall:.1f} s, tile kernel "
              f"{tile} launches; launches {launches}", flush=True)
        if tokens(inproc) != tokens(main_out):
            fail("spec phase: the in-process session's tokens differ from the launcher's")
        for name in SPEC_KERNELS:
            if launches[name] <= 0:
                fail(f"spec phase: the in-process session never launched the {name} kernel")
        if tile <= 0:
            fail("spec phase: no product took the tile kernel")
        del inproc
        torch.cuda.empty_cache()

        snap = str(tmp / "snapshot.npz")
        with ThreadPoolExecutor(3) as pool:
            runs = list(pool.map(lambda a: launcher(*a), [
                ("snapshot", "--set", "serving.snapshot_every=3",
                 "--set", f"serving.snapshot_path={snap}"),
                ("paged", "--set", "serving.pages=true"),
                ("refused", "--set", "kernels.policy=ref")]))
        snap_out, paged_out = result(runs[0]), result(runs[1])
        _, refused, _ = runs[2]
        print(f"[spec] kernels.policy=ref on the card: exit {refused.returncode}, "
              f"{refused.stderr.strip().splitlines()[-1] if refused.stderr.strip() else ''}",
              flush=True)
        if refused.returncode == 0 or "kernels.policy" not in refused.stderr:
            fail("spec phase: kernels.policy=ref on the card did not stop with the SpecError")
        restore_out = result(launcher("restore", "--set", f"serving.restore_path={snap}"))
        checks = {"snapshot run": (snap_out, snap_out["elastic"]["n_snapshots"] >= 1),
                  "restore": (restore_out, restore_out["elastic"]["n_restores"] == 1),
                  "paged run": (paged_out, bool(paged_out.get("paging")))}
        for what, (out, ran) in checks.items():
            same = tokens(out) == tokens(main_out)
            print(f"[spec] {what}: tokens equal the launcher's {same}", flush=True)
            if not (same and ran):
                fail(f"spec phase: the {what}'s tokens differ from the launcher's (or it did "
                     "not snapshot, restore or page)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cfg = get_arch("llama3.2-1b").resolve(False)
    a, slots = cfg.attn, main_out["slots"]
    prompt, max_len = spec.shape.prompt_len, spec.shape.prompt_len + spec.shape.gen + 1
    page = PAGE_TOKENS * a.n_kv_heads * a.head_dim
    errs = _arch_kernel_checks(
        dev, cfg, seed=11, prompt=prompt, decode_m=slots, tag="spec",
        kv_blocks=((slots, max_len * a.n_kv_heads * a.head_dim), (slots, page),
                   (-(-prompt // PAGE_TOKENS), page)))
    wall = time.monotonic() - t_phase
    print(f"[spec] phase 3c wall {wall:.1f} s", flush=True)
    return {"launches": launches, "errs": errs, "wall_s": wall, "spec_hash": want_hash,
            "prefill_s_per_request": main_out["prefill_s"] / n_req,
            "tokens_per_s": main_out["tokens_per_s"], "decode_s": main_out["decode_s"],
            "launcher_wall_s": main_out["wall_s"], "in_process_wall_s": inproc_wall,
            "runs_wall_s": {k: v["wall_s"] for k, v in (("snapshot", snap_out),
                                                         ("paged", paged_out),
                                                         ("restore", restore_out))},
            "tokens": tokens(main_out)}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def check_lm_card_vs_cpu(dev, gen, arch: str, prompt_len: int,
                         shared_cache: bool = False) -> dict:
    """The reduced ``arch`` on the card against the same model on the CPU
    (plain versions): prefill logits of two rows, then one decode step.
    Logits of a 3-5 layer model: the fp32 sums of kernel and plain version
    differ in order, which moves a quantized activation by one 2**-16 step
    at most, far below 1e-3 at the logits.  With ``shared_cache`` the
    prefill caches are held to one bf16 ulp at each leaf's largest
    magnitude, and both devices decode from the CPU's cache: a bf16 cache
    leaf one rounding apart moved the reduced recurrentgemma-9b's decode
    logits by 3.5e-3 (its RG-LRU state; 7.4e-5 from a shared cache), so
    decoding from each device's own cache holds the roundings, not the
    step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_decode_step, lm_init, lm_prefill, pad_cache
    from repro_torch.models.moe import record_routing

    cfg = get_arch(arch).resolve(reduced=True)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    p_cpu = lm_init(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, prompt_len), generator=gen)
    # a VLM's image prefix ahead of the tokens
    img = (torch.randn(2, cfg.vlm_prefix_len, cfg.d_model, generator=gen).to(torch.bfloat16)
           if cfg.vlm_prefix_len else None)
    with record_routing() as r_cpu:
        lg_cpu, c_cpu = lm_prefill(p_cpu, cfg, toks, ctx, img)
    with record_routing() as r_gpu:
        lg_gpu, c_gpu = lm_prefill(_to(p_cpu, dev), cfg, toks.to(dev), ctx,
                                   None if img is None else img.to(dev))
    # an MoE model's routing first: a near-tie that flips under another
    # summation order sends a token to another expert
    flips = sum(int((a["gate_idx"].cpu() != b["gate_idx"].cpu()).sum())
                for a, b in zip(r_cpu, r_gpu))
    cache_ulps = 0.0
    if shared_cache:
        for key in (k for k in c_cpu if k != "pos"):
            for name, want in c_cpu[key].items():
                want = want.float()
                ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())) - 7)
                cache_ulps = max(cache_ulps, float((c_gpu[key][name].float().cpu() - want)
                                                   .abs().max() / ulp))
        c_gpu = _to(c_cpu, dev)
    nxt = lg_cpu.argmax(-1)
    d_cpu, _ = lm_decode_step(p_cpu, cfg, nxt, pad_cache(c_cpu, 1), ctx)
    d_gpu, _ = lm_decode_step(_to(p_cpu, dev), cfg, nxt.to(dev), pad_cache(c_gpu, 1), ctx)
    e_pre = float((lg_gpu.cpu() - lg_cpu).abs().max())
    e_dec = float((d_gpu.cpu() - d_cpu).abs().max())
    print(f"[check] reduced {arch} card vs CPU, prompt {prompt_len}: prefill logits "
          f"max_abs_err={e_pre:.3g}, decode {e_dec:.3g}"
          + (f" (from the CPU's cache; the caches {cache_ulps:.3g} ulps apart at their "
             "largest magnitudes)" if shared_cache else "")
          + f" (atol 1e-3), argmax equal {bool(torch.equal(lg_gpu.argmax(-1).cpu(), nxt))}"
          + (f"; prefill router assignments that differ: {flips}" if r_cpu else ""),
          flush=True)
    if not (e_pre <= 1e-3 and e_dec <= 1e-3 and cache_ulps <= 1.0):
        fail(f"the reduced {arch} on the card disagrees with the CPU plain versions")
    return {"prefill_max_abs_err": e_pre, "decode_max_abs_err": e_dec,
            "cache_max_ulps": cache_ulps if shared_cache else None,
            "router_flips": flips if r_cpu else None}


def profile_prefill(dev, arch: str, prompt: int) -> dict:
    """(6f) one full-width ``arch`` prefill of ``prompt`` tokens under
    torch.profiler, after one warm-up prefill: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_init, lm_prefill

    torch.cuda.empty_cache()
    cfg = get_arch(arch).resolve(False)
    params = lm_init(cfg, 0, device=dev)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    toks = torch.randint(0, cfg.vocab, (1, prompt),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    lm_prefill(params, cfg, toks, ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        lm_prefill(params, cfg, toks, ctx)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    busy = sum(r[1] for r in rows)
    tag = f"prefill-profile {arch} {prompt}"
    if busy == 0:
        print(f"[{tag}] {wall_ms:.1f} ms wall; device time not measured", flush=True)
    else:
        print(f"[{tag}] {wall_ms:.1f} ms wall (profiled), device busy {busy:.1f} ms = "
              f"{busy / wall_ms:.1%}; top kernels:", flush=True)
        for name, ms, n in rows[:12]:
            print(f"[{tag}]   {ms:9.2f} ms  x{n:<5d} {name[:90]}", flush=True)
    del params
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:40]]}


# -- slice 9: the rest of the serving engine ---------------------------------------

# 6g: llama3.2-1b with 8 requests of prompt 512 over 4 slots (a rescale to 2
# spills two of them), mamba2-780m with 6 of prompt 256; gen GEN
SURVIVE_SLOTS, SURVIVE_REQUESTS, SURVIVE_PROMPT = 4, 8, 512
SURVIVE_SAMPLED = 4  # requests of the sampled-decode runs
SURVIVE_MAMBA_REQUESTS, SURVIVE_MAMBA_PROMPT = 6, 256
SURVIVE_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy",
                   "flash_attention", "mask_pack")
SURVIVE_MAMBA_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "ssd_scan")


def _bytes_by_part(tree: dict) -> dict:
    """Bytes of a pool or a slot payload by part: the KV leaves' values,
    mask words and nnz, and the dense leaves (``pos`` and SSM state)."""
    from repro_torch.serving.kvpool import PackedKV

    out = dict.fromkeys(("values", "mask", "nnz", "dense"), 0)
    for node in tree.values():
        for leaf in (node.values() if isinstance(node, dict) else [node]):
            if isinstance(leaf, PackedKV):
                leaf = {part: getattr(leaf, part) for part in ("values", "mask", "nnz")}
            if isinstance(leaf, dict):
                for part, x in leaf.items():
                    out[part] += x.nbytes
            else:
                out["dense"] += leaf.nbytes
    out["total"] = sum(out.values())
    return out


def _decode_logits(engine, slots: list, width: int):
    """Decode logits of the engine's ``slots`` computed in a pool of ``width``
    slots holding their exact packed bits (slot i of it = slots[i]) and
    nothing else, with each slot's next token fed: the engine's own decode
    step, unpack to repack."""
    import torch

    from repro_torch.serving import kvpool

    pool = kvpool.init_pool(engine.cfg, width, engine.max_len, device=engine.device)
    tokens = torch.zeros(width, dtype=torch.int64)
    for i, slot in enumerate(slots):
        kvpool.restore_slot_packed(pool, kvpool.extract_slot_packed(engine.pool, slot), i)
        tokens[i] = int(engine._next_tok[slot])
    logits, _ = engine._decode(engine.params, tokens.to(engine.device),
                               kvpool.unpack_cache(pool))
    return logits[:len(slots)].float().cpu()


def _batch_invariance(engine, tag: str, phase: str = "survive") -> dict:
    """Slots 0 and 1's decode logits in a pool of 4 slots (all four
    resident) and of 2 (those two alone): the largest difference and
    whether the bits agree."""
    import torch

    four = _decode_logits(engine, [0, 1, 2, 3], 4)[:2]
    two = _decode_logits(engine, [0, 1], 2)
    diff = float((four - two).abs().max())
    equal = bool(torch.equal(four, two))
    print(f"[{phase}] {tag}: decode logits of slots 0-1 at 4 slots vs at 2 slots: max |diff| "
          f"= {diff:.3g}, bit-equal {equal}", flush=True)
    if not equal:
        fail(f"{phase} phase: {tag}'s decode logits depend on the number of slots")
    return {"max_abs_diff": diff, "bit_equal": equal}


def _survive_model(dev, arch: str, requests: int, prompt: int, schedule: list, tag: str,
                   roundtrip: bool, needed: tuple) -> tuple:
    """One model of 6g: the oracle run, then the same requests under
    ``schedule`` through ChaosHarness (a kill builds a fresh engine over the
    same parameter tensors); every request's tokens must equal the oracle's
    and requests must have spilled and resumed.  With ``roundtrip`` an
    explicit snapshot -> .npz -> load -> restore at tick 3 is timed first.
    The launch counters are zeroed just before the chaos run and read just
    after it; each kernel in ``needed`` must have launched there.  Returns
    the report and ``submitted(n, greedy)``, which builds an engine over the
    model with its first ``n`` requests queued."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import kvpool
    from repro_torch.serving.elastic import ChaosHarness, load_snapshot, save_snapshot
    from repro_torch.serving.engine import ServingEngine

    torch.cuda.empty_cache()
    cfg = get_arch(arch).resolve(False)
    params = lm_init(cfg, 0, device=dev)
    prompts = synthetic_prompts(requests, requests, prompt, cfg.vocab, 0)

    def make(greedy: bool = True):
        return ServingEngine(cfg, serving_config("quant_sparse"), params=params,
                             n_slots=SURVIVE_SLOTS, max_len=prompt + GEN + 1, greedy=greedy,
                             spec_hash=f"chip-smoke-{arch}", device=dev)

    def submitted(n: int = requests, greedy: bool = True):
        eng = make(greedy)
        for i, p in enumerate(prompts[:n]):
            eng.submit_prompt(p, GEN, seed=i)
        return eng

    def tokens(out) -> list:
        return [r["tokens"] for r in out["per_request"]]

    res: dict = {"arch": arch, "requests": requests, "prompt": prompt,
                 "schedule": [(e.at, e.kind, e.slots) for e in schedule]}
    t0 = time.monotonic()
    oracle = submitted().run()
    res["oracle_s"] = time.monotonic() - t0
    res["oracle_tokens_per_s"] = oracle["tokens_per_s"]
    want = tokens(oracle)
    if not oracle["finite"] or any(len(t) != GEN for t in want):
        fail(f"survive phase: {tag}'s uninterrupted run did not finish every request")

    eng = submitted()
    for _ in range(3):
        eng.step()
    res["pool_bytes"] = _bytes_by_part(eng.pool)
    res["payload_bytes"] = _bytes_by_part(kvpool.extract_slot_packed(eng.pool, 0))
    res["batch_invariance"] = _batch_invariance(eng, tag)
    if roundtrip:
        path = ROOT / "build" / f"survive_{arch}.npz"
        path.parent.mkdir(exist_ok=True)
        t1 = time.monotonic()
        snap = eng.snapshot()
        t2 = time.monotonic()
        save_snapshot(snap, str(path))
        t3 = time.monotonic()
        loaded = load_snapshot(str(path))
        t4 = time.monotonic()
        eng.restore(loaded)
        torch.cuda.synchronize()
        t5 = time.monotonic()
        res.update(snapshot_s=t2 - t1, save_s=t3 - t2, load_s=t4 - t3, restore_s=t5 - t4,
                   npz_bytes=path.stat().st_size)
        path.unlink()
        print(f"[survive] {tag}: .npz round trip at tick 3: {res['npz_bytes']} bytes, snapshot "
              f"{res['snapshot_s']:.3f} s, save {res['save_s']:.3f} s, load {res['load_s']:.3f} s, "
              f"restore {res['restore_s']:.3f} s", flush=True)
    harness = ChaosHarness(eng, schedule, make_engine=make, max_steps=500)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t1 = time.monotonic()
    out = harness.run()
    torch.cuda.synchronize()
    res["chaos_s"] = time.monotonic() - t1
    res["launches"] = kernels.launch_counts()
    print(f"[survive] {tag}: launches in the chaos run {res['launches']}", flush=True)
    for name in needed:
        if res["launches"][name] <= 0:
            fail(f"survive phase: {tag}'s chaos run never launched the {name} kernel")
    got = tokens(out)
    res["elastic"] = out["elastic"]
    res["tokens_equal"] = got == want
    print(f"[survive] {tag}: {requests} requests, prompt {prompt}, {SURVIVE_SLOTS} slots; oracle "
          f"{res['oracle_s']:.1f} s ({oracle['tokens_per_s']:.1f} tokens/s); chaos "
          f"{res['schedule']} {res['chaos_s']:.1f} s: tokens equal {res['tokens_equal']}, "
          f"{out['elastic']}", flush=True)
    if not res["tokens_equal"]:
        fail(f"survive phase: {tag}'s tokens under chaos differ from the uninterrupted run's")
    if out["elastic"]["n_spills"] <= 0 or out["elastic"]["n_resumes"] <= 0:
        fail(f"survive phase: {tag}'s chaos schedule did not both spill and resume")
    print(f"[survive] {tag}: bytes of the pool {res['pool_bytes']}, of one slot's payload "
          f"{res['payload_bytes']}", flush=True)
    res["spill_resume"] = _time_spill_resume(submitted(SURVIVE_SLOTS), want[:SURVIVE_SLOTS], tag)
    res["oracle_tokens"] = want
    return res, submitted


def _time_spill_resume(eng, want: list, tag: str, reps: int = 5) -> dict:
    """One ``_spill_slot`` and one ``_resume_one`` (through the admit phase,
    whose only work is the resume), each ending at a device sync, ``reps``
    times on slot 0 of a full pool after one tick; then the run finishes
    with the uninterrupted run's tokens."""
    import torch

    eng.step()
    spill, resume = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._spill_slot(0)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        eng._admit_phase()
        torch.cuda.synchronize()
        spill.append((t1 - t0) * 1e3)
        resume.append((time.monotonic() - t1) * 1e3)
    got = [r["tokens"] for r in eng.run()["per_request"]]
    print(f"[survive] {tag}: _spill_slot {min(spill):.2f} ms (min of {reps}; "
          f"mean {sum(spill) / reps:.2f}), _resume_one {min(resume):.2f} ms (mean "
          f"{sum(resume) / reps:.2f}); tokens after {reps} spills equal {got == want}", flush=True)
    if got != want:
        fail(f"survive phase: {tag}'s tokens after repeated spills differ")
    return {"spill_ms": spill, "resume_ms": resume}


def phase_survive(dev) -> dict:
    """(6g) spill/resume, live rescale, exact snapshots, the chaos harness,
    sampled decode and telemetry, on full-width llama3.2-1b and
    mamba2-780m; each model's launch counts are those of its chaos run
    alone."""
    import torch

    from repro_torch import telemetry
    from repro_torch.serving.elastic import ChaosEvent, ChaosHarness

    t_phase = time.monotonic()
    llama, submitted = _survive_model(
        dev, "llama3.2-1b", SURVIVE_REQUESTS, SURVIVE_PROMPT,
        [ChaosEvent(2, "roundtrip"), ChaosEvent(4, "rescale", slots=2),
         ChaosEvent(6, "snapshot"), ChaosEvent(9, "rescale", slots=4),
         ChaosEvent(12, "rewind"), ChaosEvent(15, "kill")], "llama3.2-1b", roundtrip=True,
        needed=SURVIVE_KERNELS)

    # sampled decode: twice, then through a snapshot and a rewind
    sampled = []
    for schedule in ([], [], [ChaosEvent(3, "snapshot"), ChaosEvent(8, "rewind")]):
        eng = submitted(SURVIVE_SAMPLED, greedy=False)
        out = ChaosHarness(eng, schedule).run()
        sampled.append([r["tokens"] for r in out["per_request"]])
    greedy_first = llama["oracle_tokens"][:SURVIVE_SAMPLED]
    print(f"[survive] sampled decode, {SURVIVE_SAMPLED} requests: two runs and a rewound one "
          f"equal {sampled[0] == sampled[1] == sampled[2]}; differ from greedy "
          f"{sampled[0] != greedy_first}; first {sampled[0][0][:8]}", flush=True)
    if not sampled[0] == sampled[1] == sampled[2]:
        fail("survive phase: sampled decode gave other tokens on a rerun or after a rewind")

    # telemetry on: the oracle's workload inside a scope
    tel_eng = submitted()
    t0 = time.monotonic()
    with telemetry.scope(telemetry.TelemetryConfig(enabled=True)) as tracer:
        tel_out = tel_eng.run()
        n_spans = len(tracer)
    tel_s = time.monotonic() - t0
    tel_equal = [r["tokens"] for r in tel_out["per_request"]] == llama["oracle_tokens"]
    print(f"[survive] telemetry on: {n_spans} spans, {tel_out['tokens_per_s']:.1f} tokens/s "
          f"against {llama['oracle_tokens_per_s']:.1f} off, run {tel_s:.1f} s against "
          f"{llama['oracle_s']:.1f} s; tokens equal {tel_equal}", flush=True)
    if not tel_equal:
        fail("survive phase: telemetry changed a token")
    del submitted, eng, tel_eng  # the model's parameters go with them
    torch.cuda.empty_cache()

    mamba, submitted = _survive_model(
        dev, "mamba2-780m", SURVIVE_MAMBA_REQUESTS, SURVIVE_MAMBA_PROMPT,
        [ChaosEvent(2, "rescale", slots=2), ChaosEvent(4, "snapshot"),
         ChaosEvent(7, "rescale", slots=4), ChaosEvent(10, "rewind")], "mamba2-780m",
        roundtrip=False, needed=SURVIVE_MAMBA_KERNELS)
    del submitted
    torch.cuda.empty_cache()
    wall = time.monotonic() - t_phase
    print(f"[survive] phase 6g wall {wall:.1f} s", flush=True)
    return {"llama": llama, "mamba2": mamba, "sampled_tokens": sampled,
            "telemetry": {"spans": n_spans, "tokens_per_s": tel_out["tokens_per_s"],
                          "tokens_per_s_off": llama["oracle_tokens_per_s"], "run_s": tel_s,
                          "run_s_off": llama["oracle_s"], "tokens_equal": tel_equal},
            "launches": {name: llama["launches"][name] + mamba["launches"][name]
                         for name in llama["launches"]},
            "wall_s": wall}


# -- slice 10: the paged pool, minitron-4b and mistral-nemo-12b ---------------------

# 6h: llama3.2-1b on the paged pool, 4 slots, 8 requests of 500-512 tokens
# whose first 256 are one system prompt, gen GEN, 8 tokens a page, max_len
# 530 (not a multiple of the page), 8 page installs a tick
PAGED_SLOTS, PAGED_REQUESTS, PAGED_SYSTEM, PAGED_MAX_LEN = 4, 8, 256, 530
PAGED_PROMPTS = (500, 512)  # the shortest and the longest prompt
PAGE_TOKENS, PREFILL_CHUNK = 8, 8
PAGED_KERNELS = ("masked_matmul_skinny", "masked_matmul", "flash_attention", "mask_pack")
# 6i: 4 requests of prompt 512 on 4 slots, paged then monolithic; both
# models' d_ff (9216, 14336) exceed the 8192-long split-K chunk
ARCHS_NEW, ARCH_REQUESTS, ARCH_PROMPT = ("minitron-4b", "mistral-nemo-12b"), 4, 512
ARCH_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "splitk_reduce",
                "flash_attention", "mask_pack")


def _store_bytes(store_arrays: dict) -> dict:
    """Bytes of the paged store's arrays by part."""
    out = dict.fromkeys(("values", "mask", "nnz"), 0)
    for leaf in store_arrays.values():
        for part, t in leaf.items():
            out[part] += t.nbytes
    out["total"] = sum(out.values())
    return out


def _decode_split(out: dict) -> dict:
    """What an engine summary's tokens/s is made of: decode ticks, their
    mean ms and their mean occupancy (tokens/s = occupancy x slots / ms)."""
    steps = max(out["decode_steps"], 1)
    return {"decode_steps": out["decode_steps"], "ms_per_decode": out["decode_s"] * 1e3 / steps,
            "mean_occupancy": out["mean_occupancy"], "ticks": out["latency"]["ticks"]}


def _drive(eng) -> tuple:
    """A paged engine's ``run()`` stepped by hand, the scheduler's
    invariants checked and the most frames shared at once kept after
    every tick; returns (summary, that count)."""
    shared = 0
    while eng.sched.has_work():
        eng.step()
        eng.sched.check_invariants()
        shared = max(shared, len(eng.table.shared_frames()))
    return eng.summary(), shared


def _paged_tick_profile(eng, ticks: int = 3) -> dict:
    """Three decode ticks of a full pool under torch.profiler
    (:func:`_tick_profile`).  ``eng`` installs whole prompts at admission
    (``prefill_chunk=None``), so its first tick admits every slot and the
    next ones decode all of them; each packs its k and v pages in one
    ``mask_pack`` launch a leaf."""
    eng.step()
    if eng._installing or len(eng._decode_slots()) < PAGED_SLOTS:
        fail(f"paged phase: {len(eng._decode_slots())} of {PAGED_SLOTS} slots decode "
             f"after the admitting tick")
    res = _tick_profile(eng, "paged", ticks, f" at ~{PAGED_MAX_LEN} rows")
    if res["launches_per_tick"].get("mask_pack") != 2:
        fail(f"a paged decode tick must pack its k and v pages in one mask_pack launch "
             f"each: {res['launches_per_tick']}")
    return res


def phase_paged(dev) -> dict:
    """(6h) full-width llama3.2-1b on the paged copy-on-write pool: the
    uninterrupted paged run (the main path: counters zeroed just before,
    read just after), the same requests on the monolithic engine, and a
    chaos run (an .npz round trip, the page budget cut to two requests'
    worth with spills, raised back, a rewind).  Paged tokens must equal
    monolithic tokens, chaos tokens the uninterrupted ones; a prefix hit,
    a spill and a resume must happen."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving.elastic import ChaosEvent, ChaosHarness, load_snapshot, save_snapshot
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paging import PagedServingEngine

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    cfg = get_arch("llama3.2-1b").resolve(False)
    params = lm_init(cfg, 0, device=dev)
    system = synthetic_prompts(1, 1, PAGED_SYSTEM, cfg.vocab, 0)[0]
    lo, hi = PAGED_PROMPTS
    prompts = [system + synthetic_prompts(1, 1, lo + (hi - lo) * i // (PAGED_REQUESTS - 1)
                                          - PAGED_SYSTEM, cfg.vocab, 1 + i)[0]
               for i in range(PAGED_REQUESTS)]
    spring = serving_config("quant_sparse")
    common = dict(params=params, n_slots=PAGED_SLOTS, max_len=PAGED_MAX_LEN,
                  spec_hash="chip-smoke-paged", device=dev)

    def submitted(paged: bool = True, n: int = PAGED_REQUESTS, chunk=PREFILL_CHUNK):
        eng = (PagedServingEngine(cfg, spring, page_tokens=PAGE_TOKENS, prefill_chunk=chunk,
                                  **common)
               if paged else ServingEngine(cfg, spring, **common))
        for i, p in enumerate(prompts[:n]):
            eng.submit_prompt(p, GEN, seed=i)
        return eng

    def tokens(out) -> list:
        return [r["tokens"] for r in out["per_request"]]

    def timed_run(paged: bool) -> tuple:
        """(summary, s) of one ``run()`` of the requests, nothing else timed."""
        eng = submitted(paged=paged)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = eng.run()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    res: dict = {"prompt_lens": [len(p) for p in prompts]}
    eng = submitted()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    drive, shared = _drive(eng)
    torch.cuda.synchronize()
    res["launches"] = kernels.launch_counts()
    want = tokens(drive)
    pg = drive["paging"]
    res.update(paging=pg, shared_frames_max=shared, store_bytes=_store_bytes(eng.store_arrays))
    num_pages = pg["num_pages"]
    del eng
    # both engines timed the same way: the run above also checks the
    # scheduler's invariants and counts shared frames after every tick
    out, res["paged_s"] = timed_run(paged=True)
    res.update(paged_tokens_per_s=out["tokens_per_s"], finite=out["finite"],
               paged_prefill_s_per_request=out["prefill_s"] / PAGED_REQUESTS,
               paged_decode=_decode_split(out), paged_rerun_equal=tokens(out) == want)
    print(f"[paged] llama3.2-1b quant_sparse, {PAGED_REQUESTS} requests of "
          f"{min(res['prompt_lens'])}-{max(res['prompt_lens'])} tokens ({PAGED_SYSTEM} shared), "
          f"{PAGED_SLOTS} slots, max_len {PAGED_MAX_LEN}, {PAGE_TOKENS} tokens a page: "
          f"{res['paged_s']:.1f} s, {out['tokens_per_s']:.1f} tokens/s ({res['paged_decode']}), "
          f"finite={out['finite']}; "
          f"{num_pages} pages ({pg['logical_frames']} frames), prefix hits {pg['prefix_hits']}, "
          f"cow {pg['cow_copies']}, at most {shared} frames shared, peak page utilization "
          f"{pg['peak_page_utilization']:.3f}; page arrays {res['store_bytes']}", flush=True)
    print(f"[paged] launches {res['launches']}", flush=True)
    if not (drive["finite"] and out["finite"]) or any(len(t) != GEN for t in want):
        fail("paged phase: the uninterrupted paged run did not finish every request")
    if not res["paged_rerun_equal"]:
        fail("paged phase: a second uninterrupted paged run gave other tokens")
    for name in PAGED_KERNELS:
        if res["launches"][name] <= 0:
            fail(f"paged phase never launched the {name} kernel")
    if pg["prefix_hits"] <= 0 or shared <= 0:
        fail("paged phase: the shared system prompt made no prefix hit")

    mono, res["mono_s"] = timed_run(paged=False)
    res["mono_tokens_per_s"] = mono["tokens_per_s"]
    res["mono_decode"] = _decode_split(mono)
    res["paged_equals_monolithic"] = tokens(mono) == want
    print(f"[paged] monolithic engine, the same requests: {res['mono_s']:.1f} s, "
          f"{mono['tokens_per_s']:.1f} tokens/s ({res['mono_decode']}); paged tokens equal "
          f"{res['paged_equals_monolithic']}", flush=True)
    if not res["paged_equals_monolithic"]:
        first = next(i for i, (a, b) in enumerate(zip(tokens(mono), want)) if a != b)
        fail(f"paged phase: request {first}'s paged tokens {want[first]} differ from the "
             f"monolithic engine's {tokens(mono)[first]}")

    # chaos: the budget cut to two requests' worth (a resumed request holds
    # private copies of all its pages: the rescale spills every active
    # one), a snapshot, a rewind to it, the budget raised back
    small = 2 * -(-PAGED_MAX_LEN // PAGE_TOKENS)
    schedule = [ChaosEvent(2, "roundtrip"), ChaosEvent(4, "rescale", num_pages=small),
                ChaosEvent(7, "snapshot"), ChaosEvent(10, "rewind"),
                ChaosEvent(13, "rescale", num_pages=num_pages)]
    t0 = time.monotonic()
    chaos = ChaosHarness(submitted(), schedule, max_steps=500).run()
    torch.cuda.synchronize()
    res["chaos_s"] = time.monotonic() - t0
    res["chaos_equal"] = tokens(chaos) == want
    res["chaos_elastic"] = chaos["elastic"]
    res["schedule"] = [(e.at, e.kind, e.num_pages) for e in schedule]
    print(f"[paged] chaos {res['schedule']}: {res['chaos_s']:.1f} s, tokens equal "
          f"{res['chaos_equal']}, {chaos['elastic']}", flush=True)
    if not res["chaos_equal"]:
        fail("paged phase: tokens under chaos differ from the uninterrupted run's")
    if chaos["elastic"]["n_spills"] <= 0 or chaos["elastic"]["n_resumes"] <= 0:
        fail("paged phase: the page-budget cut did not both spill and resume")

    # one full pool (whole prompts installed at admission): a profiled
    # tick, an .npz round trip, spill and resume
    eng = submitted(n=PAGED_SLOTS, chunk=None)
    res["tick"] = _paged_tick_profile(eng)
    path = ROOT / "build" / "paged_llama.npz"
    path.parent.mkdir(exist_ok=True)
    t1 = time.monotonic()
    snap = eng.snapshot()
    t2 = time.monotonic()
    save_snapshot(snap, str(path))
    t3 = time.monotonic()
    loaded = load_snapshot(str(path))
    t4 = time.monotonic()
    eng.restore(loaded)
    torch.cuda.synchronize()
    t5 = time.monotonic()
    res.update(snapshot_s=t2 - t1, save_s=t3 - t2, load_s=t4 - t3, restore_s=t5 - t4,
               npz_bytes=path.stat().st_size)
    path.unlink()
    print(f"[paged] .npz round trip of a full pool at tick {eng.tick}: {res['npz_bytes']} "
          f"bytes, snapshot {res['snapshot_s']:.3f} s, save {res['save_s']:.3f} s, load "
          f"{res['load_s']:.3f} s, restore {res['restore_s']:.3f} s", flush=True)
    spill, resume, frames = [], [], []
    for _ in range(5):
        frames.append(eng.table.n_blocks(eng._slot_rid[0]))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._spill_slot(0)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        eng._admit_phase()
        torch.cuda.synchronize()
        spill.append((t1 - t0) * 1e3)
        resume.append((time.monotonic() - t1) * 1e3)
    page_bytes = sum(s.lead_prod * (s.elems * 2 + s.words * 4 + 4)
                     for s in eng.store.leaves.values())
    got = tokens(eng.run())
    res["spill_resume"] = {"spill_ms": spill, "resume_ms": resume, "frames": frames,
                           "page_bytes": page_bytes, "tokens_equal": got == want[:PAGED_SLOTS]}
    print(f"[paged] _spill_slot of a request's {frames[0]} pages ({frames[0] * page_bytes} "
          f"bytes): {min(spill):.2f} ms (min of 5; mean {sum(spill) / 5:.2f}), _resume_one "
          f"{min(resume):.2f} ms (mean {sum(resume) / 5:.2f}); tokens after 5 spills equal "
          f"{got == want[:PAGED_SLOTS]}", flush=True)
    if got != want[:PAGED_SLOTS]:
        fail("paged phase: tokens after repeated spills differ")
    del eng, params, common, submitted, snap, loaded
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.monotonic() - t_phase
    print(f"[paged] phase 6h wall {res['wall_s']:.1f} s", flush=True)
    return res


def _flash_err(g, a, prompt: int, tag: str) -> float:
    """flash_attention at (1, H, HKV, ``prompt``, D) of the attention spec
    ``a`` (its window if it has one), causal fp32, q/k/v as ``gqa_apply``
    passes them, against its plain version at atol 2e-5 (the registry's
    compare): the largest error."""
    import torch

    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention

    dev, hd = g.device, a.head_dim
    q = torch.randn(1, prompt, a.n_heads, hd, generator=g, device=dev).transpose(1, 2)
    k, v = (torch.randn(1, prompt, a.n_kv_heads, hd, generator=g, device=dev)
            .transpose(1, 2) for _ in range(2))
    e = _max_err(flash_attention(q, k, v, window=a.window),
                 attention_reference(q, k, v, window=a.window))
    if not e <= 2e-5:
        fail(f"{tag}: flash_attention (1,{a.n_heads},{a.n_kv_heads},{prompt},{hd}) window "
             f"{a.window} off by {e:.3g}")
    return e


def _product_err(g, m: int, kk: int, n: int, tag: str, prune_ratio: float = 0.0) -> float:
    """masked_matmul on an (m, kk) @ (kk, n) product of card tensors from
    ``g`` against its plain version within 2b's bound 2 K 2**-24 (|x| @
    |w|), with x's first quarter of K and half of w's (32, 64) tiles zero
    so that a misread flag shows; on the tile kernel's route both
    operands' occupancy flags exact.  ``prune_ratio``: w is instead the
    Gaussian magnitude-pruned as ``SpringContext.maybe_prune`` prunes a
    served weight (unstructured: about no tile empty).  Returns the
    largest error."""
    import torch

    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.masked_matmul.ops import (KERNEL_TILES, masked_matmul,
                                                       masked_matmul_reference, route,
                                                       tile_occupancy, tile_occupancy_reference)

    dev = g.device
    tm, tn, tk = KERNEL_TILES

    def occ_exact(t, rows, cols) -> None:
        if not torch.equal(tile_occupancy(t, rows, cols), tile_occupancy_reference(t, rows, cols)):
            fail(f"{tag}: tile_occupancy {tuple(t.shape)} disagrees with its plain version")

    x = quantize_nearest(torch.randn(m, kk, generator=g, device=dev))
    x[:, : kk // 4] = 0.0
    w = torch.randn(kk, n, generator=g, device=dev).div_(kk**0.5)
    if prune_ratio:
        from repro_torch.models.layers import SpringContext

        w = SpringContext(prune_ratio=prune_ratio).maybe_prune(w)
    else:
        keep = torch.rand(-(-kk // tk), -(-n // tn), generator=g, device=dev) > 0.5
        w.masked_fill_(~keep.repeat_interleave(tk, 0).repeat_interleave(tn, 1)[:kk, :n], 0.0)
        del keep
    w = quantize_nearest(w)
    if route(m, n, kk) == "tile":
        occ_exact(x, tm, tk)
        occ_exact(w, tk, tn)
    got = masked_matmul(x, w, apply_sr=False)
    want = masked_matmul_reference(x, w, apply_sr=False)
    err = (got - want).abs_()
    del got, want
    ok = bool((err <= (x.abs() @ w.abs()).mul_(2 * kk * 2.0**-24)).all())
    e = float(err.max())
    if not ok:
        fail(f"{tag}: masked_matmul ({m},{kk})@({kk},{n}) off by {e:.3g}")
    return e


def _arch_kernel_checks(dev, cfg, seed: int, prompt: int = ARCH_PROMPT,
                        decode_m: int = ARCH_REQUESTS, kv_blocks=None,
                        tag: str = "archs", attn=None, extra_projs=None,
                        kv_layers=None, prune_ratio: float = 0.0) -> dict:
    """Each kernel of ``cfg``'s served path on card tensors at the
    full-width shapes the path gives it, against its plain version; the
    largest error of each.  flash_attention at (1, H, HKV, ``prompt``,
    D) of ``attn`` (default ``cfg.attn``; its window if it has one),
    causal fp32, q/k/v as ``gqa_apply`` passes them (atol 2e-5, the
    registry's compare); masked_matmul on every projection (and those of
    ``extra_projs``, name -> (K, N)) at
    M = ``prompt`` (the tile kernel after tile_occupancy) and
    M = ``decode_m`` (the skinny kernel) within 2b's bound
    2 K 2**-24 (|x| @ |w|), with x's first quarter of K and half of w's
    (32, 64) tiles zero so that a misread flag shows, both operands' flags
    exact; splitk_reduce bit-equal on the partial sums of the d_ff-long
    reduction at both M, where d_ff splits; kv_pack bit-equal on each
    (blocks, block length) of ``kv_blocks`` (default: a decode tick's
    pages and a request's install), ``kv_layers`` (default n_layers) of
    them; and the tile kernel with its pre-pass
    once more at the lm_head's (K, N), K x N up to 786 M, for their index
    arithmetic (the path's logits are a torch.matmul of the last rows).
    ``prune_ratio``: the projections' weights magnitude-pruned as the
    engine prunes them (:func:`_product_err`)."""
    import torch

    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.kv_cache.ops import kv_pack, kv_pack_reference
    from repro_torch.kernels.masked_matmul.ops import (route, split_k, splitk_reduce,
                                                       splitk_reduce_reference)

    g = torch.Generator(device=dev).manual_seed(seed)
    a, d, ff = attn or cfg.attn, cfg.d_model, cfg.d_ff
    hd = a.head_dim
    errs = dict.fromkeys(("flash_attention", "masked_matmul", "masked_matmul_skinny",
                          "tile_occupancy", "splitk_reduce", "mask_pack"), 0.0)
    label, tag = tag, f"{cfg.name} check"
    errs["flash_attention"] = _flash_err(g, a, prompt, tag)
    projs = {"q": (d, a.n_heads * hd), "k": (d, a.n_kv_heads * hd), "v": (d, a.n_kv_heads * hd),
             "o": (a.n_heads * hd, d), "gate": (d, ff), "up": (d, ff), "down": (ff, d),
             **(extra_projs or {})}
    for m in (prompt, decode_m):
        key = "masked_matmul" if route(m, 1, 1) == "tile" else "masked_matmul_skinny"
        for kk, n in projs.values():
            errs[key] = max(errs[key], _product_err(g, m, kk, n, tag, prune_ratio))
        if split_k(ff)[1] > 1:
            part = quantize_nearest(torch.randn(split_k(ff)[1], m, d, generator=g, device=dev))
            if not torch.equal(splitk_reduce(part), splitk_reduce_reference(part)):
                fail(f"{tag}: splitk_reduce {tuple(part.shape)} differs from its plain version")
    vocab = cfg.vocab
    errs["masked_matmul"] = max(errs["masked_matmul"], _product_err(g, prompt, d, vocab, tag))
    torch.cuda.empty_cache()

    page = PAGE_TOKENS * a.n_kv_heads * hd
    if kv_blocks is None:
        kv_blocks = ((decode_m, page), (prompt // PAGE_TOKENS, page))
    for blocks, block_len in kv_blocks:
        leaf = torch.relu(torch.randn(kv_layers or cfg.n_layers, blocks, block_len, generator=g,
                                      device=dev))
        leaf = leaf.to(torch.bfloat16)
        got, want = kv_pack(leaf), kv_pack_reference(leaf)
        if not all(torch.equal(got[p], want[p]) for p in ("values", "mask", "nnz")):
            fail(f"{tag}: kv_pack {tuple(leaf.shape)} bf16 differs from its plain version")
    print(f"[{label}] {cfg.name} kernels at the path's shapes against their plain versions: "
          f"flash_attention (D {hd}, window {a.window}) err {errs['flash_attention']:.3g}, "
          f"tile {errs['masked_matmul']:.3g} "
          f"(M {prompt}, lm_head ({d},{vocab}) too), skinny "
          f"{errs['masked_matmul_skinny']:.3g} (M {decode_m}); tile_occupancy, "
          f"splitk_reduce ({split_k(ff)[1]} chunks) and kv_pack "
          f"({[tuple(b) for b in kv_blocks]} blocks x elements) bit-equal", flush=True)
    return errs


def _serve_both(dev, arch: str, n_sms: int, tag: str, prepare=None) -> dict:
    """Full-width ``arch``, quant_sparse: ARCH_REQUESTS requests of prompt
    ARCH_PROMPT on as many slots, on the paged and then the monolithic
    engine over the same parameters (``prepare(params)`` edits them first);
    the launch counters are zeroed just before each run and read just
    after.  Tokens equal between the backends, finite logits, every kernel
    of ARCH_KERNELS launched in the paged run and flash_attention in the
    monolithic one.  The parameters are freed before it returns."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import plan
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paging import PagedServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch).resolve(False)
    a = cfg.attn
    tile = plan(1, a.n_heads, a.n_kv_heads, ARCH_PROMPT, a.head_dim, n_sms)
    params = lm_init(cfg, 0, device=dev)
    if prepare is not None:
        prepare(params)
    n_params = sum(t.numel() for t in _tensors(params))
    prompts = synthetic_prompts(ARCH_REQUESTS, ARCH_REQUESTS, ARCH_PROMPT, cfg.vocab, 0)
    row: dict = {"params": n_params, "tile": tile._asdict()}
    for backend in ("paged", "monolithic"):
        kw = dict(params=params, n_slots=ARCH_REQUESTS, max_len=ARCH_PROMPT + GEN + 1,
                  device=dev)
        eng = (PagedServingEngine(cfg, serving_config("quant_sparse"),
                                  page_tokens=PAGE_TOKENS, **kw) if backend == "paged"
               else ServingEngine(cfg, serving_config("quant_sparse"), **kw))
        del kw  # the engine holds the parameters; nothing else may
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, GEN, seed=i)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = eng.run()
        torch.cuda.synchronize()
        row[backend] = {"wall_s": time.monotonic() - t0, "launches": kernels.launch_counts(),
                        "tokens": [r["tokens"] for r in out["per_request"]],
                        "finite": out["finite"], "tokens_per_s": out["tokens_per_s"],
                        "prefill_s_per_request": out["prefill_s"] / ARCH_REQUESTS,
                        "decode": _decode_split(out)}
        del eng, out
    row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    p, m = row["paged"], row["monolithic"]
    row["tokens_equal"] = p["tokens"] == m["tokens"]
    print(f"[{tag}] {arch} ({n_params / 1e9:.2f} B parameters, D {a.head_dim}, "
          f"H {a.n_heads} / HKV {a.n_kv_heads}, flash tile {tile.rows} rows x "
          f"{tile.heads_per_cta} heads), {ARCH_REQUESTS} requests of prompt {ARCH_PROMPT}: "
          f"paged {p['prefill_s_per_request']:.3f} s prefill per request, "
          f"{p['tokens_per_s']:.2f} tokens/s ({p['decode']}); monolithic "
          f"{m['prefill_s_per_request']:.3f} s, {m['tokens_per_s']:.2f} tokens/s "
          f"({m['decode']}); peak {row['peak_mem_bytes'] / 2**30:.2f} GiB; "
          f"tokens equal {row['tokens_equal']}, finite {p['finite'] and m['finite']}",
          flush=True)
    print(f"[{tag}] {arch} launches, paged run {p['launches']}", flush=True)
    if not (p["finite"] and m["finite"]) or any(len(t) != GEN for t in p["tokens"]):
        fail(f"{tag} phase: {arch} did not finish every request with finite logits")
    if not row["tokens_equal"]:
        fail(f"{tag} phase: {arch}'s paged tokens differ from its monolithic tokens")
    for name in ARCH_KERNELS:
        if p["launches"][name] <= 0:
            fail(f"{tag} phase: {arch}'s paged run never launched the {name} kernel")
    if m["launches"]["flash_attention"] <= 0:
        fail(f"{tag} phase: {arch}'s monolithic run never launched flash_attention")
    del params
    gc.collect()  # the next model must not find this one's 20-49 GB still held
    torch.cuda.empty_cache()
    return row


def _sum_launches(runs: list) -> dict:
    return {name: sum(r[name] for r in runs) for name in runs[0]}


def phase_archs(dev, gen) -> dict:
    """(6i) full-width minitron-4b and mistral-nemo-12b, quant_sparse: 4
    requests of prompt 512 on 4 slots, on the paged and then the
    monolithic engine over the same parameters (:func:`_serve_both`);
    each kernel of the path against its plain version at the model's
    shapes (:func:`_arch_kernel_checks`); then each reduced model on the
    card against the CPU."""
    import torch

    from repro_torch.configs import get_arch

    t_phase = time.monotonic()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    res: dict = {}
    for arch in ARCHS_NEW:
        row = _serve_both(dev, arch, n_sms, "archs")
        row["kernel_errs"] = _arch_kernel_checks(dev, get_arch(arch).resolve(False),
                                                 seed=len(res))
        torch.cuda.empty_cache()
        res[arch] = row
    res["check"] = {arch: check_lm_card_vs_cpu(dev, gen, arch, CHECK_PROMPT)
                    for arch in ARCHS_NEW}
    res["errs"] = {name: max(res[arch]["kernel_errs"][name] for arch in ARCHS_NEW)
                   for name in res[ARCHS_NEW[0]]["kernel_errs"]}
    res["launches"] = _sum_launches([res[arch][backend]["launches"] for arch in ARCHS_NEW
                                     for backend in ("paged", "monolithic")])
    res["wall_s"] = time.monotonic() - t_phase
    print(f"[archs] phase 6i wall {res['wall_s']:.1f} s", flush=True)
    return res


# -- slice 13: the hybrid family and the qkv bias ------------------------------------

# 6j: recurrentgemma-9b (12 x (rglru, rglru, local) + 2 rglru; local attention
# D 256, 16 heads on one kv head, window 2048), 4 requests of prompt 2600
# (past the window, not a multiple of a tile) on 4 slots, gen GEN; qwen2-7b
# (qkv bias) as 6i's archs, its biases random and non-zero
RG_ARCH, RG_REQUESTS, RG_PROMPT = "recurrentgemma-9b", 4, 2600
RG_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "splitk_reduce",
              "mask_pack", "flash_attention", "flash_attention_d256")
QWEN_ARCH = "qwen2-7b"
# the timed D 256 shape: B 1, S 4096 at recurrentgemma's local attention
FA256_S = 4096
HBM_80GB = 80e9


def _live_pairs(s: int, window: int) -> int:
    """Causal (query, key) pairs with key > query - window, over S queries."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _fa256_row(dev, gen, a) -> dict:
    """flash_attention at D 256 on ``a`` (recurrentgemma's local attention)
    at S FA256_S, causal, its window, fp32, q/k/v as ``gqa_apply`` passes
    them: the error against the plain version (atol 2e-5), a call's time (a
    timed loop), its device time with L2 flushed and its host time, beside
    the plain version, fp32 scaled_dot_product_attention with enable_gqa
    and a boolean band mask, and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention, plan

    s, h, hkv, d, w = FA256_S, a.n_heads, a.n_kv_heads, a.head_dim, a.window
    q = torch.randn(1, s, h, d, generator=gen).to(dev).transpose(1, 2)
    k, v = (torch.randn(1, s, hkv, d, generator=gen).to(dev).transpose(1, 2) for _ in range(2))
    idx = torch.arange(s, device=dev)
    band = (idx[:, None] >= idx[None, :]) & (idx[None, :] > idx[:, None] - w)

    def kernel():
        return flash_attention(q, k, v, causal=True, window=w)

    def plain():
        return attention_reference(q, k, v, causal=True, window=w)

    def lib():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=True)

    want = plain()
    e, lib_e = _max_err(kernel(), want), _max_err(lib(), want)
    del want
    if not e <= 2e-5:
        fail(f"flash_attention D {d} S {s} window {w} off by {e:.3g}")
    ms, dev_ms = timed(kernel, 10), cold_device_ms(kernel, iters=10)
    host = host_ms(kernel, iters=20, warmup=3)
    plain_ms = timed(plain, 2, warmup=1)
    lib_ms, lib_dev_ms = timed(lib, 10), cold_device_ms(lib, iters=10)
    torch.cuda.empty_cache()
    flops = 4.0 * h * _live_pairs(s, w) * d
    b_ms, b_by = bound(4.0 * s * d * (2 * h + 2 * hkv), flops)
    tile = plan(1, h, hkv, s, d, torch.cuda.get_device_properties(dev).multi_processor_count)
    row = {"seq": s, "head_dim": d, "window": w, "tile": tile._asdict(), "ms": ms,
           "device_ms": dev_ms, "host_ms": host, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_device_ms": lib_dev_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": e, "library_max_abs_err": lib_e, "tflops": flops / ms / 1e9,
           "device_tflops": flops / dev_ms / 1e9}
    print(f"[hybrid] flash_attention B1 H{h} HKV{hkv} D{d} S{s} causal window {w} fp32, tile "
          f"{tile.rows} rows = {tile.heads_per_cta} heads x {tile.positions} positions, "
          f"{tile.ctas} CTAs: err {e:.3g}; kernel {ms:.4f} ms ({row['tflops']:.2f} TFLOP/s), "
          f"device {dev_ms:.4f} ms with L2 flushed, host {host:.4f} ms; plain {plain_ms:.4f} "
          f"ms, sdpa {lib_ms:.4f} ms (device {lib_dev_ms:.4f}, err {lib_e:.3g}), bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    del q, k, v, band
    return row


def _tick_profile(eng, tag: str, ticks: int = 3, where: str = "") -> dict:
    """``ticks`` decode ticks of an engine whose slots are all decoding,
    under torch.profiler (device activity only: a MoE tick issues tens of
    thousands of ops, and host events would multiply the trace and the time
    to read it): wall and device ms a tick, launches a tick."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / ticks
    per_tick = {k: v / ticks for k, v in kernels.launch_counts().items() if v}
    rows = device_time_by_kernel(prof, ticks)
    busy = sum(r[1] for r in rows)
    print(f"[{tag}] decode tick, {eng.n_slots} slots{where}: {wall_ms:.2f} ms wall (profiled), "
          "device "
          + (f"{busy:.2f} ms = {busy / wall_ms:.1%}" if busy else "not measured")
          + f"; launches a tick {per_tick}", flush=True)
    for name, ms, n in rows[:8]:
        print(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:90]}", flush=True)
    return {"tick_ms": wall_ms, "device_busy_ms": busy, "launches_per_tick": per_tick,
            "kernels": [{"name": n, "ms_per_tick": ms, "calls_per_tick": c}
                        for n, ms, c in rows[:20]]}


def _serve_recurrentgemma(dev, n_sms: int) -> dict:
    """recurrentgemma-9b at full width, random weights from seed 0, on the
    monolithic engine: RG_REQUESTS requests of prompt RG_PROMPT on as many
    slots, the counters zeroed just before ``run()`` and read just after
    (every kernel of RG_KERNELS must launch, the D 256 flash_attention among
    them), finite logits, peak memory under the card's 80 GB.  Then a second
    engine over the same parameters with the same prompts admitted in one
    tick: slots 0-1's decode logits at 4 and 2 slots bit-equal (RG-LRU
    state, rings and all), three profiled decode ticks.  The paged engine
    must refuse the arch (no pageable leaf)."""
    import torch

    from repro_torch import kernels
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import plan
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paging import PagedServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    cfg = get_arch(RG_ARCH).resolve(False)
    a = cfg.local_attn
    tile = plan(1, a.n_heads, a.n_kv_heads, RG_PROMPT, a.head_dim, n_sms)
    params = lm_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    prompts = synthetic_prompts(RG_REQUESTS, RG_REQUESTS, RG_PROMPT, cfg.vocab, 0)
    spring = serving_config("quant_sparse")
    kw = dict(params=params, n_slots=RG_REQUESTS, max_len=RG_PROMPT + GEN + 1, device=dev)

    eng = ServingEngine(cfg, spring, **kw)
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, GEN, seed=i)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    del eng
    tokens = [r["tokens"] for r in out["per_request"]]
    row = {"params": n_params, "init_s": init_s, "tile": tile._asdict(), "wall_s": wall,
           "launches": launches, "tokens": tokens, "finite": out["finite"],
           "tokens_per_s": out["tokens_per_s"],
           "prefill_s_per_request": out["prefill_s"] / RG_REQUESTS,
           "decode": _decode_split(out)}
    print(f"[hybrid] {RG_ARCH} ({n_params / 1e9:.2f} B parameters, made in {init_s:.1f} s; "
          f"local attention D {a.head_dim}, H {a.n_heads} / HKV {a.n_kv_heads}, window "
          f"{a.window}, flash tile {tile.rows} rows x {tile.heads_per_cta} heads), "
          f"{RG_REQUESTS} requests of prompt {RG_PROMPT}: {row['prefill_s_per_request']:.3f} s "
          f"prefill per request, {row['tokens_per_s']:.2f} tokens/s ({row['decode']}), "
          f"finite {out['finite']}, wall {wall:.1f} s", flush=True)
    print(f"[hybrid] {RG_ARCH} launches {launches}", flush=True)
    if not out["finite"] or any(len(t) != GEN for t in tokens):
        fail(f"hybrid phase: {RG_ARCH} did not finish every request with finite logits")
    for name in RG_KERNELS:
        if launches[name] <= 0:
            fail(f"hybrid phase: {RG_ARCH}'s run never launched the {name} kernel")

    eng = ServingEngine(cfg, spring, **kw)
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, GEN, seed=i)
    eng.step()  # admits all four, then their first decode tick
    if len(eng._decode_slots()) != RG_REQUESTS:
        fail(f"hybrid phase: {len(eng._decode_slots())} of {RG_REQUESTS} slots decode "
             "after the admitting tick")
    row["batch_invariance"] = _batch_invariance(eng, RG_ARCH, "hybrid")
    row["decode_profile"] = _tick_profile(eng, "hybrid")
    again = [r["tokens"] for r in eng.run()["per_request"]]
    del eng
    if again != tokens:
        fail(f"hybrid phase: {RG_ARCH}'s tokens differ between two runs of the same requests")
    row["peak_mem_bytes"] = peak = torch.cuda.max_memory_allocated()
    print(f"[hybrid] {RG_ARCH} peak {peak / 2**30:.2f} GiB; the same tokens on a second "
          "engine", flush=True)
    if not peak < HBM_80GB:
        fail(f"hybrid phase: {RG_ARCH} peaked at {peak / 1e9:.1f} GB")
    try:
        PagedServingEngine(cfg, spring, page_tokens=PAGE_TOKENS, **kw)
    except ValueError as e:
        row["paged_refusal"] = str(e)
    else:
        fail(f"hybrid phase: the paged engine took {RG_ARCH}, which has no pageable leaf")
    if RG_ARCH not in row["paged_refusal"]:
        fail(f"hybrid phase: the paged refusal does not name the arch: {row['paged_refusal']}")
    print(f"[hybrid] paged engine refused: {row['paged_refusal']}", flush=True)
    del params, kw
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_hybrid(dev, gen) -> dict:
    """(6j) the hybrid family and the qkv bias: full-width recurrentgemma-9b
    (:func:`_serve_recurrentgemma`) and each kernel of its path against its
    plain version at the shapes the path gives it (flash_attention at D 256
    with the window at S RG_PROMPT, masked_matmul on every projection,
    the RG-LRU's included, at M RG_PROMPT and RG_REQUESTS, kv_pack on the
    ring leaf), the D 256 flash_attention timed at S FA256_S; full-width
    qwen2-7b with random non-zero qkv biases as 6i's archs; then each
    reduced model on the card against the CPU."""
    import torch

    from repro_torch.configs import get_arch

    t_phase = time.monotonic()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    res: dict = {RG_ARCH: _serve_recurrentgemma(dev, n_sms)}
    cfg = get_arch(RG_ARCH).resolve(False)
    a, dr = cfg.local_attn, cfg.rglru.d_rnn
    ring = a.window * a.n_kv_heads * a.head_dim
    res[RG_ARCH]["kernel_errs"] = errs = _arch_kernel_checks(
        dev, cfg, seed=13, prompt=RG_PROMPT, decode_m=RG_REQUESTS, tag="hybrid", attn=a,
        extra_projs={"wx": (cfg.d_model, dr), "wy": (cfg.d_model, dr), "wo": (dr, cfg.d_model)},
        kv_blocks=((RG_REQUESTS, ring), (1, ring)), kv_layers=cfg.n_units)
    errs["flash_attention_d256"] = errs["flash_attention"]
    torch.cuda.empty_cache()
    res["fa256"] = fa = _fa256_row(dev, gen, a)
    errs["flash_attention_d256"] = max(errs["flash_attention_d256"], fa["max_abs_err"])

    def random_biases(params):
        g = torch.Generator(device=dev).manual_seed(23)
        for layer in params["layers"]:
            for name in ("wq", "wk", "wv"):
                bias = layer["mixer"][name]["bias"]
                bias.copy_(torch.randn(bias.shape, generator=g, device=dev).mul_(0.5))
        if any(bool((layer["mixer"][n]["bias"] == 0).all()) for layer in params["layers"]
               for n in ("wq", "wk", "wv")):
            fail("hybrid phase: a qkv bias of qwen2-7b stayed zero")

    res[QWEN_ARCH] = _serve_both(dev, QWEN_ARCH, n_sms, "hybrid", prepare=random_biases)
    res[QWEN_ARCH]["kernel_errs"] = _arch_kernel_checks(
        dev, get_arch(QWEN_ARCH).resolve(False), seed=14, tag="hybrid")
    torch.cuda.empty_cache()
    archs = (RG_ARCH, QWEN_ARCH)
    res["check"] = {arch: check_lm_card_vs_cpu(dev, gen, arch, CHECK_PROMPT, shared_cache=True)
                    for arch in archs}
    res["errs"] = {name: max(res[arch]["kernel_errs"].get(name, 0.0) for arch in archs)
                   for name in errs}
    q = res[QWEN_ARCH]
    res["launches"] = _sum_launches([res[RG_ARCH]["launches"], q["paged"]["launches"],
                                     q["monolithic"]["launches"]])
    res["wall_s"] = time.monotonic() - t_phase
    print(f"[hybrid] phase 6j wall {res['wall_s']:.1f} s", flush=True)
    return res


# -- slice 14: the MoE family ----------------------------------------------------------

# 6k: olmoe-1b-7b (16 x (attn, moe): MHA D 128, 64 experts top-8 of d_ff 1024) and
# deepseek-v2-lite-16b (an MLA layer with a dense SwiGLU of d_ff 10944, then 26 x
# (mla, moe): 64 routed experts top-6 of d_ff 1408 and 2 shared), 4 requests of
# prompt 512 on 4 slots, gen GEN, max_len 530, PAGE_TOKENS a page, monolithic then
# paged.  Capacity max(int(T k / E 1.25 + 0.999), 4): 80 (olmoe) and 60 (deepseek)
# at a prompt-512 prefill, 4 at a decode tick of 4 slots
MOE_ARCHS, MOE_REQUESTS, MOE_PROMPT = ("olmoe-1b-7b", "deepseek-v2-lite-16b"), 4, 512
#: tokens a request decodes in 6k, cut from GEN (16) as later phases came,
#: to keep the whole script inside its time limit (host-bound MoE ticks of
#: 1.1 / 1.9 s, three engines each); the third engine takes three ticks
MOE_GEN = 3  # 16 before phase 5h, 8 before phase 8, 4 before 8g
MOE_MAX_LEN = MOE_PROMPT + GEN + 2
MOE_TRAFFIC = (MOE_REQUESTS, MOE_PROMPT, MOE_GEN, MOE_MAX_LEN)
MOE_KERNELS = {"olmoe-1b-7b": ("masked_matmul_skinny", "masked_matmul", "tile_occupancy",
                               "mask_pack", "flash_attention"),
               "deepseek-v2-lite-16b": ("masked_matmul_skinny", "masked_matmul",
                                        "tile_occupancy", "splitk_reduce", "mask_pack")}


def _capacity(spec, t: int) -> int:
    return max(int((t * spec.top_k / spec.n_experts) * spec.capacity_factor + 0.999), 4)


def _routing_stats(rec: list, n_experts: int) -> dict:
    """A ``moe.record_routing`` list of one kind of call (prefill or decode)
    summed: assignments dropped, tokens per expert (min / mean / max over
    experts and calls), the share of (call, expert) pairs no token reached,
    the share of the dispatch buffers' rows left zero (capacity no
    assignment used), and the expert products' share of skipped tile steps
    at the kernel's tiles."""
    import torch

    counts = torch.stack([torch.bincount(r["gate_idx"].reshape(-1), minlength=n_experts)
                          for r in rec]).cpu()
    caps = torch.tensor([r["capacity"] for r in rec])
    used = torch.minimum(counts, caps[:, None]).sum()
    issued = sum(r["tile_steps"][0] for r in rec)
    total = sum(r["tile_steps"][1] for r in rec)
    return {"calls": len(rec), "tokens": rec[0]["tokens"], "capacity": int(caps[0]),
            "dropped": int(sum(int((~r["keep"]).sum()) for r in rec)),
            "assignments": int(counts.sum()),
            "tokens_per_expert": [int(counts.min()), float(counts.float().mean()),
                                  int(counts.max())],
            "idle_expert_share": float((counts == 0).float().mean()),
            "zero_row_share": 1.0 - float(used) / float(caps.sum() * n_experts),
            "tile_skip_share": 1.0 - issued / total}


def _moe_kernel_checks(dev, cfg, seed: int) -> dict:
    """Each kernel of ``cfg``'s served path against its plain version at
    6k's shapes: masked_matmul on the expert products at decode (M 4, the
    skinny kernel) and at a prompt-512 prefill's capacity (the tile kernel
    after tile_occupancy), on the attention or MLA projections and the
    dense / shared SwiGLU at M MOE_PROMPT and MOE_REQUESTS; splitk_reduce
    on the partial sums of a K > 8192 reduction (deepseek's dense layer);
    flash_attention at olmoe's prefill (D 128, H 16 on 16 kv heads: one
    head a tile); kv_pack bit-equal (one mask_pack launch a call) on every
    pool leaf at a decode tick (one block per (layer, slot)) and at the
    pages of a tick and an install, with mask_pack's route for each.
    Returns the largest error of each kernel."""
    import torch

    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.flash_attention.ops import plan as fa_plan
    from repro_torch.kernels.kv_cache.ops import kv_pack, kv_pack_reference
    from repro_torch.kernels.mask_compress.ops import plan as mp_plan
    from repro_torch.kernels.masked_matmul.ops import (route, split_k, splitk_reduce,
                                                       splitk_reduce_reference)

    g = torch.Generator(device=dev).manual_seed(seed)
    tag, d, moe = f"{cfg.name} check", cfg.d_model, cfg.moe
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = dict.fromkeys(("flash_attention", "masked_matmul", "masked_matmul_skinny",
                          "tile_occupancy", "splitk_reduce", "mask_pack"), 0.0)
    cap = _capacity(moe, MOE_PROMPT)
    experts = {"expert gate/up": (d, moe.d_ff), "expert down": (moe.d_ff, d)}
    if cfg.attn is not None:
        a = cfg.attn
        projs = {"q": (d, a.n_heads * a.head_dim), "kv": (d, a.n_kv_heads * a.head_dim),
                 "o": (a.n_heads * a.head_dim, d)}
        errs["flash_attention"] = _flash_err(g, a, MOE_PROMPT, tag)
        tile = fa_plan(1, a.n_heads, a.n_kv_heads, MOE_PROMPT, a.head_dim, n_sms)
        print(f"[moe] {cfg.name}: flash_attention (1,{a.n_heads},{a.n_kv_heads},{MOE_PROMPT},"
              f"{a.head_dim}) err {errs['flash_attention']:.3g}, tile {tile.rows} rows x "
              f"{tile.heads_per_cta} heads", flush=True)
    else:
        m = cfg.mla
        projs = {"wq": (d, m.n_heads * (m.qk_nope_dim + m.qk_rope_dim)),
                 "wdkv": (d, m.kv_lora_rank), "wkr": (d, m.qk_rope_dim),
                 "wo": (m.n_heads * m.v_head_dim, d)}
    ffns = [cfg.d_ff] if cfg.d_ff else []
    if moe.n_shared:
        ffns.append(moe.shared_d_ff * moe.n_shared)
    for ff in ffns:
        projs.update({f"swiglu {ff} gate/up": (d, ff), f"swiglu {ff} down": (ff, d)})
    for m_rows, shapes in ((MOE_REQUESTS, {**projs, **experts}), (cap, experts),
                           (MOE_PROMPT, projs)):
        key = "masked_matmul" if route(m_rows, 1, 1) == "tile" else "masked_matmul_skinny"
        for kk, n in shapes.values():
            errs[key] = max(errs[key], _product_err(g, m_rows, kk, n, tag))
    for ff in ffns:
        if split_k(ff)[1] > 1:
            for m_rows in (MOE_REQUESTS, MOE_PROMPT):
                part = quantize_nearest(torch.randn(split_k(ff)[1], m_rows, d, generator=g,
                                                    device=dev))
                if not torch.equal(splitk_reduce(part), splitk_reduce_reference(part)):
                    fail(f"{tag}: splitk_reduce {tuple(part.shape)} differs from its plain "
                         "version")
    torch.cuda.empty_cache()

    # every pool leaf: (layers, per-(layer, slot) row width) of its block
    if cfg.attn is not None:
        leaves = {"k/v": (cfg.n_layers, cfg.attn.n_kv_heads * cfg.attn.head_dim)}
    else:
        leaves = {"ckv": (cfg.n_layers, cfg.mla.kv_lora_rank),
                  "krope": (cfg.n_layers, cfg.mla.qk_rope_dim)}
    routes = {}
    for name, (layers, row) in leaves.items():
        cases = {"decode tick": (MOE_REQUESTS, MOE_MAX_LEN * row),
                 "tick pages": (MOE_REQUESTS, PAGE_TOKENS * row),
                 "install pages": (MOE_PROMPT // PAGE_TOKENS, PAGE_TOKENS * row)}
        for case, (blocks, block_len) in cases.items():
            leaf = torch.relu(torch.randn(layers, blocks, block_len, generator=g, device=dev))
            leaf = leaf.to(torch.bfloat16)
            got, want = kv_pack(leaf), kv_pack_reference(leaf)
            if not all(torch.equal(got[p], want[p]) for p in ("values", "mask", "nnz")):
                fail(f"{tag}: kv_pack {tuple(leaf.shape)} bf16 ({name}, {case}) differs from "
                     "its plain version")
            routes[f"{name} {case}"] = mp_plan(layers * blocks, block_len, 2, True,
                                               n_sms).route
    print(f"[moe] {cfg.name} kernels at the path's shapes against their plain versions: tile "
          f"{errs['masked_matmul']:.3g} (experts at M {cap}, projections at M {MOE_PROMPT}), "
          f"skinny {errs['masked_matmul_skinny']:.3g} (M {MOE_REQUESTS}), over "
          f"{sorted(projs) + sorted(experts)}; tile_occupancy, splitk_reduce and kv_pack "
          f"bit-equal; mask_pack routes {routes}", flush=True)
    return {"errs": errs, "mask_pack_routes": routes}


def _serve_moe(dev, arch: str) -> dict:
    """Full-width ``arch``, quant_sparse, random weights from seed 0:
    MOE_REQUESTS requests of prompt MOE_PROMPT, MOE_GEN tokens each, on as
    many slots through the
    monolithic and then the paged engine (whole-prompt installs) over the
    same parameters, the
    launch counters zeroed just before each ``run()`` and read just after
    (every kernel of MOE_KERNELS launched in each; flash_attention never
    for deepseek's MLA), paged tokens equal to the monolithic ones.  Then
    a third engine admits the four at once, holds slots 0-1's decode
    logits at 4 and 2 slots bit-equal, profiles three decode ticks, and
    runs one more tick and one request's prefill under
    ``moe.record_routing`` (routing, drops and the experts' skipped tile
    steps).  Peak memory under the card's 80 GB.  The parameters are
    freed before it returns."""
    import torch

    from repro_torch import kernels
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_init, lm_prefill
    from repro_torch.models.moe import record_routing
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paging import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch).resolve(False)
    t0 = time.monotonic()
    params = lm_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    prompts = synthetic_prompts(MOE_REQUESTS, MOE_REQUESTS, MOE_PROMPT, cfg.vocab, 0)
    spring = serving_config("quant_sparse")
    kw = dict(params=params, n_slots=MOE_REQUESTS, max_len=MOE_MAX_LEN, device=dev)
    row: dict = {"params": n_params, "init_s": init_s,
                 "capacity": {"prefill": _capacity(cfg.moe, MOE_PROMPT),
                              "decode": _capacity(cfg.moe, MOE_REQUESTS)}}
    for backend in ("monolithic", "paged"):
        # the paged engine installs whole prompts at admission: its chunked
        # installs (6h, 6i) would hold decode at 0.4 occupancy and double
        # the phase's time on host-bound ticks
        eng = (ServingEngine(cfg, spring, **kw) if backend == "monolithic"
               else PagedServingEngine(cfg, spring, page_tokens=PAGE_TOKENS, prefill_chunk=None,
                                       **kw))
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, MOE_GEN, seed=i)
        # the monolithic run is 8h's unsharded one: it records what 8h's
        # near-tie rule reads
        rec = _engine_gaps(eng, first_logits=True) if backend == "monolithic" else None
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        with _moe_routing(rec, cfg.moe.top_k) if rec else contextlib.nullcontext():
            out = eng.run()
        torch.cuda.synchronize()
        row[backend] = {"wall_s": time.monotonic() - t0, "launches": kernels.launch_counts(),
                        "tokens": [r["tokens"] for r in out["per_request"]],
                        "finite": out["finite"], "tokens_per_s": out["tokens_per_s"],
                        "prefill_s_per_request": out["prefill_s"] / MOE_REQUESTS,
                        "decode": _decode_split(out)}
        if rec:
            row[backend]["record"] = _ep_record(eng, out, rec)
        del eng, out, rec
    m, p = row["monolithic"], row["paged"]
    row["tokens_equal"] = p["tokens"] == m["tokens"]
    print(f"[moe] {arch} ({n_params / 1e9:.2f} B parameters, made in {init_s:.1f} s; capacity "
          f"{row['capacity']['prefill']} at prefill, {row['capacity']['decode']} at decode), "
          f"{MOE_REQUESTS} requests of prompt {MOE_PROMPT}: monolithic "
          f"{m['prefill_s_per_request']:.3f} s prefill per request, {m['tokens_per_s']:.2f} "
          f"tokens/s ({m['decode']}), wall {m['wall_s']:.1f} s; paged "
          f"{p['prefill_s_per_request']:.3f} s, {p['tokens_per_s']:.2f} tokens/s "
          f"({p['decode']}), wall {p['wall_s']:.1f} s; tokens equal {row['tokens_equal']}, "
          f"finite {m['finite'] and p['finite']}", flush=True)
    print(f"[moe] {arch} launches, monolithic run {m['launches']}", flush=True)
    print(f"[moe] {arch} launches, paged run {p['launches']}", flush=True)
    if not (m["finite"] and p["finite"]) or any(len(t) != MOE_GEN for t in m["tokens"]):
        fail(f"moe phase: {arch} did not finish every request with finite logits")
    if not row["tokens_equal"]:
        fail(f"moe phase: {arch}'s paged tokens differ from its monolithic tokens")
    for backend in ("monolithic", "paged"):
        launches = row[backend]["launches"]
        for name in MOE_KERNELS[arch]:
            if launches[name] <= 0:
                fail(f"moe phase: {arch}'s {backend} run never launched the {name} kernel")
        if cfg.attn is None and launches["flash_attention"] != 0:
            fail(f"moe phase: {arch}'s {backend} run launched flash_attention "
                 f"{launches['flash_attention']} times: MLA prefill is the chunked attention")

    t0 = time.monotonic()
    eng = ServingEngine(cfg, spring, **kw)
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, MOE_GEN, seed=i)
    eng.step()  # admits all four, then their first decode tick
    if len(eng._decode_slots()) != MOE_REQUESTS:
        fail(f"moe phase: {len(eng._decode_slots())} of {MOE_REQUESTS} slots decode after "
             "the admitting tick")
    row["batch_invariance"] = _batch_invariance(eng, arch, "moe")
    row["decode_profile"] = _tick_profile(eng, "moe", ticks=1, where=f" ({arch})")
    # the routing of one decode tick and of one request's prefill (each
    # recorded product syncs the host)
    with record_routing() as rec_decode:
        eng.step()
    del eng
    with record_routing() as rec_prefill:
        lm_prefill(params, cfg, torch.tensor([prompts[0]], device=dev), SpringContext(cfg=spring))
    e = cfg.moe.n_experts
    row["routing"] = {"prefill": _routing_stats(rec_prefill, e),
                      "decode": _routing_stats(rec_decode, e)}
    del rec_prefill, rec_decode
    for kind, st in row["routing"].items():
        what = "a decode tick" if kind == "decode" else "one prefill"
        print(f"[moe] {arch} {kind} routing ({what}: {st['calls']} MoE calls of {st['tokens']} "
              f"tokens, capacity {st['capacity']}): {st['dropped']} of {st['assignments']} "
              f"assignments dropped; tokens per expert min/mean/max {st['tokens_per_expert']}; "
              f"experts no token reached {st['idle_expert_share']:.1%}; dispatch rows left "
              f"zero {st['zero_row_share']:.1%}; expert products' tile steps skipped "
              f"{st['tile_skip_share']:.1%}", flush=True)
    if row["routing"]["decode"]["dropped"]:
        fail(f"moe phase: {arch} dropped a decode assignment at {MOE_REQUESTS} slots "
             f"(capacity {row['capacity']['decode']})")
    row["third_engine_s"] = time.monotonic() - t0
    row["peak_mem_bytes"] = peak = torch.cuda.max_memory_allocated()
    print(f"[moe] {arch} peak {peak / 2**30:.2f} GiB; the third engine (admission, invariance, "
          f"profiled and recorded ticks, a recorded prefill) took {row['third_engine_s']:.1f} s",
          flush=True)
    if not peak < HBM_80GB:
        fail(f"moe phase: {arch} peaked at {peak / 1e9:.1f} GB")
    del params, kw
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_moe(dev, gen) -> dict:
    """(6k) the MoE family: full-width olmoe-1b-7b and deepseek-v2-lite-16b
    through both engines (:func:`_serve_moe`), each kernel of their paths
    against its plain version at the shapes the path gives it
    (:func:`_moe_kernel_checks`), then each reduced model on the card
    against the CPU (the decode from the CPU's cache)."""
    from repro_torch.configs import get_arch

    t_phase = time.monotonic()
    res: dict = {}
    for i, arch in enumerate(MOE_ARCHS):
        res[arch] = _serve_moe(dev, arch)
        t0 = time.monotonic()
        res[arch].update(_moe_kernel_checks(dev, get_arch(arch).resolve(False), seed=24 + i))
        res[arch]["kernel_checks_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    res["check"] = {arch: check_lm_card_vs_cpu(dev, gen, arch, CHECK_PROMPT, shared_cache=True)
                    for arch in MOE_ARCHS}
    res["check_s"] = time.monotonic() - t0
    print(f"[moe] kernel checks {[round(res[a]['kernel_checks_s'], 1) for a in MOE_ARCHS]} s, "
          f"card-vs-CPU checks {res['check_s']:.1f} s", flush=True)
    res["errs"] = {name: max(res[arch]["errs"][name] for arch in MOE_ARCHS)
                   for name in res[MOE_ARCHS[0]]["errs"]}
    res["launches"] = _sum_launches([res[arch][backend]["launches"] for arch in MOE_ARCHS
                                     for backend in ("monolithic", "paged")])
    res["wall_s"] = time.monotonic() - t_phase
    print(f"[moe] phase 6k wall {res['wall_s']:.1f} s", flush=True)
    return res


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


# -- slice 15: whisper-medium, internvl2-26b's image prefix, the int8 KV cache --------

# 6l: whisper-medium (24 + 24 layers, d 1024, 16 heads, enc_seq 1500) from a
# spec through the launcher, batch 4, prompt 16, gen 16; internvl2-26b at
# every width (d 6144, 48 heads on 8 kv heads: a GQA group of 6), 4 requests
# of 512 text tokens behind the 256-position image prefix, gen 16, 4 slots,
# monolithic then paged; llama3.2-1b's int8 KV cache on the static path
S15_BATCH, WHISPER_PROMPT = 4, 16
WHISPER_SETS = ("arch.id=whisper-medium", "arch.reduced=false", "numerics.mode=quant_sparse",
                f"shape.batch={S15_BATCH}", f"shape.prompt_len={WHISPER_PROMPT}",
                f"shape.gen={GEN}")
# the encoder and the cross-K/V projections run under a default (dense)
# SpringContext in both packages' static path: only decode's products
# take the kernels
WHISPER_KERNELS = ("masked_matmul_skinny",)
VLM_ARCH, VLM_PROMPT = "internvl2-26b", 512
# 45 of its 48 layers (18.69 B parameters, 69.63 GiB of fp32 weights): all
# 48 (73.99 GiB) ran out of the card's 79.18 GiB at the first decode tick's
# repack and 46 left 2.91 GiB free at the peak, 45 left 4.48 (H100 80GB
# HBM3); the phase fails unless VLM_HEADROOM bytes stay free at its peak
VLM_LAYERS, VLM_HEADROOM = 45, 3 * 2**30
VLM_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "splitk_reduce",
               "flash_attention", "mask_pack")
INT8_PROMPT = 512
INT8_SETS = ("arch.reduced=false", "numerics.mode=quant_sparse", "serving.static=true",
             f"shape.batch={S15_BATCH}", f"shape.prompt_len={INT8_PROMPT}", f"shape.gen={GEN}")
INT8_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "flash_attention")


def _serve_whisper(dev) -> dict:
    """Full-width whisper-medium from a spec: ``python -m
    repro_torch.launch.serve --set arch.id=whisper-medium ...`` as a
    subprocess, then an in-process ``ServeSession`` over the same spec with
    the counters zeroed just before and read just after: tokens equal,
    finite, every kernel of WHISPER_KERNELS launched.  Printed: the
    encoder and cross-K/V seconds (the static path's prefill_s), tokens/s,
    peak memory."""
    import os
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.api import ServeSession, build_spec
    from repro_torch.launch.serve import CLI_BASE

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_whisper_") as tmp:
        out_json = pathlib.Path(tmp) / "whisper.json"
        argv = [sys.executable, "-m", "repro_torch.launch.serve",
                *[a for item in WHISPER_SETS for a in ("--set", item)], "--json", str(out_json)]
        t0 = time.monotonic()
        p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=SPEC_TIMEOUT_S)
        launcher_wall = time.monotonic() - t0
        if p.returncode != 0:
            fail(f"slice15 phase: the whisper-medium launcher run exited {p.returncode}:\n"
                 f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
        launched = json.loads(out_json.read_text())
    spec = build_spec("serve", data=CLI_BASE, data_label="launcher-default",
                      sets=list(WHISPER_SETS))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = ServeSession(spec, device=dev).run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    tokens = out["generated"].tolist()
    row = {"launcher_wall_s": launcher_wall, "launcher_prefill_s": launched["prefill_s"],
           "launcher_tokens_per_s": launched["tokens_per_s"], "wall_s": wall,
           "encoder_cross_kv_s": out["prefill_s"], "decode_s": out["decode_s"],
           "tokens_per_s": out["tokens_per_s"], "finite": out["finite"], "launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "tokens": tokens,
           "tokens_equal": launched["generated"] == tokens,
           "spec_hash": launched["spec_hash"]}
    print(f"[slice15] whisper-medium from the spec through the launcher: "
          f"{launched['tokens_per_s']:.2f} tokens/s, encoder + cross-K/V "
          f"{launched['prefill_s']:.3f} s, wall {launcher_wall:.1f} s; in process: encoder + "
          f"cross-K/V {out['prefill_s']:.3f} s for {S15_BATCH} x 1500 frames, "
          f"{out['tokens_per_s']:.2f} tokens/s ({GEN} steps of {S15_BATCH}), peak "
          f"{row['peak_mem_bytes'] / 2**30:.2f} GiB; tokens equal the launcher's "
          f"{row['tokens_equal']}, finite {out['finite']}; launches {launches}", flush=True)
    if not (row["tokens_equal"] and out["finite"] and launched["finite"]):
        fail("slice15 phase: whisper-medium's in-process tokens differ from the launcher's "
             "(or a logit is not finite)")
    for name in WHISPER_KERNELS:
        if launches[name] <= 0:
            fail(f"slice15 phase: whisper-medium never launched the {name} kernel")
    return row


def _whisper_card_vs_cpu(dev, gen) -> dict:
    """The reduced whisper-medium from one CPU init on both devices: the
    cross K/V each device builds (the encoder runs dense, bf16: the
    roundings of another sum order flip, so rel 3e-2 of the largest
    magnitude, ``tests/test_torch_encdec.py``'s dense tolerance), the first
    decode step's logits from the CPU's cache (atol 1e-3, as the LM
    checks; from each device's own cache they are printed), and the static
    session's greedy tokens (equal)."""
    import torch

    from repro_torch.api import ServeSession, build_spec
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.encdec import encdec_decode_step, encdec_init, encdec_init_cache
    from repro_torch.models.layers import SpringContext

    cfg = get_arch("whisper-medium").resolve(reduced=True)
    p_cpu = encdec_init(cfg, 0, device="cpu")
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2,), generator=gen)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    caches = {d: encdec_init_cache(_to(p_cpu, d), cfg, frames.to(d), SpringContext(), 9)
              for d in ("cpu", dev)}
    cross = max(float((caches[dev]["cross"][n].float().cpu() - caches["cpu"]["cross"][n].float())
                      .abs().max() / caches["cpu"]["cross"][n].float().abs().max())
                for n in ("k", "v"))

    def first_step(d, cache):
        return encdec_decode_step(_to(p_cpu, d), cfg, toks.to(d), _to(cache, d), ctx)[0].cpu()

    want = first_step("cpu", caches["cpu"])
    err = float((first_step(dev, caches["cpu"]) - want).abs().max())
    own = float((first_step(dev, caches[dev]) - want).abs().max())
    spec = build_spec("serve", sets=["arch.id=whisper-medium", "numerics.mode=quant_sparse",
                                     "shape.batch=2", "shape.prompt_len=8", "shape.gen=8"])
    tokens = [ServeSession(spec, params=_to(p_cpu, d), device=d).run()["generated"].tolist()
              for d in ("cpu", dev)]
    print(f"[slice15] reduced whisper-medium card vs CPU: cross K/V rel {cross:.3g} (3e-2); "
          f"first decode step's logits from the CPU's cache max_abs_err={err:.3g} (atol 1e-3), "
          f"from the card's own cache {own:.3g}; static tokens equal {tokens[0] == tokens[1]}",
          flush=True)
    if not (cross <= 3e-2 and err <= 1e-3 and tokens[0] == tokens[1]):
        fail("slice15 phase: the reduced whisper-medium on the card disagrees with the CPU")
    return {"cross_kv_rel_err": cross, "decode_max_abs_err": err,
            "decode_max_abs_err_own_cache": own, "tokens_equal": True}


def _serve_vlm(dev) -> dict:
    """internvl2-26b at every width and VLM_LAYERS layers, random weights from
    seed 0: S15_BATCH requests of VLM_PROMPT text tokens behind their
    synthetic image prefixes on the monolithic and then the paged engine
    (whole-prompt installs) over the same parameters, counters zeroed just
    before each run() and read just after (every kernel of VLM_KERNELS in
    each), paged tokens = monolithic tokens; a third engine admits the four
    at once: decode logits of slots 0-1 at 4 and 2 slots bit-equal, three
    profiled ticks.  At least VLM_HEADROOM of the card free at the peak."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.api.sessions import synthetic_images, synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paging import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(VLM_ARCH).resolve(False), n_layers=VLM_LAYERS,
                              n_units=VLM_LAYERS)
    t0 = time.monotonic()
    params = lm_init(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    prompts = synthetic_prompts(S15_BATCH, S15_BATCH, VLM_PROMPT, cfg.vocab, 0)
    images = synthetic_images(S15_BATCH, S15_BATCH, cfg.vlm_prefix_len, cfg.d_model, 0)
    spring = serving_config("quant_sparse")
    max_len = cfg.vlm_prefix_len + VLM_PROMPT + GEN + 1
    kw = dict(params=params, n_slots=S15_BATCH, max_len=max_len, device=dev)
    row: dict = {"layers": VLM_LAYERS, "params": n_params, "init_s": init_s,
                 "weight_bytes": 4 * n_params}

    def submitted(eng):
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, GEN, seed=i, img_embeds=images[i])
        return eng

    for backend in ("monolithic", "paged"):
        eng = submitted(ServingEngine(cfg, spring, **kw) if backend == "monolithic"
                        else PagedServingEngine(cfg, spring, page_tokens=PAGE_TOKENS,
                                                prefill_chunk=None, **kw))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = eng.run()
        torch.cuda.synchronize()
        row[backend] = {"wall_s": time.monotonic() - t0, "launches": kernels.launch_counts(),
                        "tokens": [r["tokens"] for r in out["per_request"]],
                        "finite": out["finite"], "tokens_per_s": out["tokens_per_s"],
                        "prefill_s_per_request": out["prefill_s"] / S15_BATCH,
                        "decode": _decode_split(out)}
        del eng, out
    m, p = row["monolithic"], row["paged"]
    row["tokens_equal"] = p["tokens"] == m["tokens"]
    print(f"[slice15] {VLM_ARCH} at {VLM_LAYERS} layers ({n_params / 1e9:.2f} B parameters, "
          f"{4 * n_params / 2**30:.2f} GiB fp32, made in {init_s:.1f} s), {S15_BATCH} requests "
          f"of {cfg.vlm_prefix_len} image + {VLM_PROMPT} text positions: monolithic "
          f"{m['prefill_s_per_request']:.3f} s prefill per request, {m['tokens_per_s']:.2f} "
          f"tokens/s ({m['decode']}), wall {m['wall_s']:.1f} s; paged "
          f"{p['prefill_s_per_request']:.3f} s, {p['tokens_per_s']:.2f} tokens/s "
          f"({p['decode']}), wall {p['wall_s']:.1f} s; tokens equal {row['tokens_equal']}, "
          f"finite {m['finite'] and p['finite']}", flush=True)
    print(f"[slice15] {VLM_ARCH} launches, monolithic run {m['launches']}", flush=True)
    print(f"[slice15] {VLM_ARCH} launches, paged run {p['launches']}", flush=True)
    if not (m["finite"] and p["finite"]) or any(len(t) != GEN for t in m["tokens"]):
        fail(f"slice15 phase: {VLM_ARCH} did not finish every request with finite logits")
    if not row["tokens_equal"]:
        fail(f"slice15 phase: {VLM_ARCH}'s paged tokens differ from its monolithic tokens")
    for backend in ("monolithic", "paged"):
        for name in VLM_KERNELS:
            if row[backend]["launches"][name] <= 0:
                fail(f"slice15 phase: {VLM_ARCH}'s {backend} run never launched the {name} "
                     "kernel")

    eng = submitted(ServingEngine(cfg, spring, **kw))
    eng.step()  # admits all four, then their first decode tick
    if len(eng._decode_slots()) != S15_BATCH:
        fail(f"slice15 phase: {len(eng._decode_slots())} of {S15_BATCH} slots decode after "
             "the admitting tick")
    row["batch_invariance"] = _batch_invariance(eng, VLM_ARCH, "slice15")
    row["decode_profile"] = _tick_profile(eng, "slice15", where=f" ({VLM_ARCH})")
    del eng
    row["peak_mem_bytes"] = peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    row["free_at_peak_bytes"] = total - peak
    print(f"[slice15] {VLM_ARCH} peak {peak / 2**30:.2f} GiB of the card's "
          f"{total / 2**30:.2f} GiB: {(total - peak) / 2**30:.2f} GiB free at the peak",
          flush=True)
    if total - peak < VLM_HEADROOM:
        fail(f"slice15 phase: {VLM_ARCH} at {VLM_LAYERS} layers left "
             f"{(total - peak) / 2**30:.2f} GiB of the card free (needs "
             f"{VLM_HEADROOM / 2**30:.0f})")
    del params, kw
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _serve_int8(dev) -> dict:
    """llama3.2-1b at full width on the static path, S15_BATCH prompts of
    INT8_PROMPT, gen GEN: the bf16 cache and then the int8 cache over the
    same parameters, the counters zeroed just before the int8 run and read
    just after (every kernel of INT8_KERNELS); how many tokens agree (no
    gate: the int8 cache is lossy) and the caches' bytes.  Then the reduced
    model's int8 static tokens on the card and on the CPU from one CPU init
    (equal)."""
    import torch

    from repro_torch import kernels
    from repro_torch.api import ServeSession, build_spec
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import lm_init, lm_init_cache

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("llama3.2-1b").resolve(False)
    params = lm_init(cfg, 0, device=dev)
    runs = {}
    for cache in ("bf16", "int8"):
        spec = build_spec("serve", sets=[*INT8_SETS,
                                         f"serving.int8_cache={str(cache == 'int8').lower()}"])
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = ServeSession(spec, params=params, device=dev).run()
        runs[cache] = {"tokens": out["generated"].tolist(), "finite": out["finite"],
                       "prefill_s": out["prefill_s"], "tokens_per_s": out["tokens_per_s"],
                       "launches": kernels.launch_counts()}
    del params
    agree = sum(a == b for ra, rb in zip(runs["bf16"]["tokens"], runs["int8"]["tokens"])
                for a, b in zip(ra, rb))
    rows = INT8_PROMPT + GEN
    nbytes = {c: sum(t.nbytes for u in (v for k, v in lm_init_cache(
        cfg, S15_BATCH, rows, "int8" if c == "int8" else torch.bfloat16, device="meta").items()
        if k != "pos") for t in u.values()) for c in ("bf16", "int8")}
    launches = runs["int8"]["launches"]
    print(f"[slice15] llama3.2-1b static path, {S15_BATCH} x prompt {INT8_PROMPT}, gen {GEN}: "
          f"int8 cache {runs['int8']['tokens_per_s']:.2f} tokens/s, bf16 "
          f"{runs['bf16']['tokens_per_s']:.2f}; {agree} of {S15_BATCH * GEN} tokens agree with "
          f"the bf16 cache's; cache at {rows} rows {nbytes['int8']} B int8 against "
          f"{nbytes['bf16']} B bf16 ({nbytes['int8'] / nbytes['bf16']:.4f}); launches {launches}",
          flush=True)
    if not (runs["int8"]["finite"] and runs["bf16"]["finite"]):
        fail("slice15 phase: the int8 static run's logits are not finite")
    for name in INT8_KERNELS:
        if launches[name] <= 0:
            fail(f"slice15 phase: the int8 static run never launched the {name} kernel")

    small = get_arch("llama3.2-1b").resolve(True)
    p_cpu = lm_init(small, 0, device="cpu")
    spec = build_spec("serve", sets=["numerics.mode=quant_sparse", "serving.static=true",
                                     "serving.int8_cache=true", "shape.batch=2",
                                     "shape.prompt_len=12", "shape.gen=8"])
    reduced = [ServeSession(spec, params=_to(p_cpu, d), device=d).run()["generated"].tolist()
               for d in ("cpu", dev)]
    print(f"[slice15] reduced llama3.2-1b int8 static tokens, card vs CPU: equal "
          f"{reduced[0] == reduced[1]}", flush=True)
    if reduced[0] != reduced[1]:
        fail("slice15 phase: the reduced int8 static tokens differ between the card and the CPU")
    return {"runs": runs, "tokens_agree": agree, "tokens": S15_BATCH * GEN,
            "cache_bytes": nbytes, "launches": launches, "reduced_tokens_equal": True}


def phase_slice15(dev, gen) -> dict:
    """(6l) whisper-medium from a spec (:func:`_serve_whisper`),
    internvl2-26b monolithic and paged (:func:`_serve_vlm`), the int8
    cache (:func:`_serve_int8`); every kernel of those paths against its
    plain version at the shapes they give it; the reduced whisper-medium
    and internvl2-26b on the card against the CPU."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    t_phase = time.monotonic()
    res: dict = {"whisper": _serve_whisper(dev), "vlm": _serve_vlm(dev), "int8": _serve_int8(dev)}
    t0 = time.monotonic()
    g = torch.Generator(device=dev).manual_seed(25)
    errs = {"masked_matmul": 0.0, "masked_matmul_skinny": 0.0}
    # whisper: decode's products at M = batch (skinny), and the encoder's
    # and cross-K/V's at M = batch x 1500 (the tile kernel; the static path
    # runs them dense)
    for m in (S15_BATCH, S15_BATCH * 1500):
        key = "masked_matmul_skinny" if m <= 32 else "masked_matmul"
        for kk, n in ((1024, 1024), (1024, 4096), (4096, 1024)):
            errs[key] = max(errs[key], _product_err(g, m, kk, n, "whisper-medium check"))
    vlm = dataclasses.replace(get_arch(VLM_ARCH).resolve(False), n_layers=VLM_LAYERS,
                              n_units=VLM_LAYERS)
    a, rows = vlm.attn, vlm.vlm_prefix_len + VLM_PROMPT
    row_len = (rows + GEN + 1) * a.n_kv_heads * a.head_dim
    page = PAGE_TOKENS * a.n_kv_heads * a.head_dim
    vlm_errs = _arch_kernel_checks(dev, vlm, seed=26, prompt=rows, decode_m=S15_BATCH,
                                   tag="slice15", kv_blocks=((S15_BATCH, row_len),
                                                             (S15_BATCH, page),
                                                             (-(-rows // PAGE_TOKENS), page)))
    llama = get_arch("llama3.2-1b").resolve(False)
    int8_errs = _arch_kernel_checks(dev, llama, seed=27, prompt=INT8_PROMPT, decode_m=S15_BATCH,
                                    tag="slice15", kv_blocks=())
    res["errs"] = {name: max(errs.get(name, 0.0), vlm_errs[name], int8_errs[name])
                   for name in vlm_errs}
    res["kernel_checks_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    res["check"] = {"whisper-medium": _whisper_card_vs_cpu(dev, gen),
                    VLM_ARCH: check_lm_card_vs_cpu(dev, gen, VLM_ARCH, CHECK_PROMPT)}
    res["check_s"] = time.monotonic() - t0
    res["launches"] = _sum_launches([res["whisper"]["launches"],
                                     res["vlm"]["monolithic"]["launches"],
                                     res["vlm"]["paged"]["launches"], res["int8"]["launches"]])
    res["wall_s"] = time.monotonic() - t_phase
    print(f"[slice15] kernel checks {res['kernel_checks_s']:.1f} s, card-vs-CPU checks "
          f"{res['check_s']:.1f} s; phase 6l wall {res['wall_s']:.1f} s", flush=True)
    return res


# -- slice 4: the kernel sweep and the paper evaluation ----------------------------

# the dangling filter at VGG-19's first activation at batch 32 (the size
# stochastic_round is timed at)
DF_SHAPE = (VGG_BATCH, VGG_HW, VGG_HW, 64)
SWEEP_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "tile_occupancy",
                 "mask_pack", "dangling_filter", "stochastic_round", "flash_attention",
                 "ssd_scan")
PAPER_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw")


def phase_dangling_filter(dev, gen) -> dict:
    """(7a) dangling_filter bit for bit against its plain version on the
    table's examples, on -0.0 / NaN / inf entries at a length that is not a
    multiple of 4 (the scalar tail), on an unaligned view, in bf16, and at
    32 x 224 x 224 x 64 fp32; then timed there beside its plain version and
    its bound."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.kernels.mask_compress.ops import dangling_filter, dangling_filter_reference

    def bits(t):
        return t.view(torch.int32) if t.element_size() == 4 else t.view(torch.int16)

    err = 0.0  # max |kernel - plain| over every case (NaN positions equal)

    def check(name, a, w) -> None:
        nonlocal err
        got, want = dangling_filter(a, w), dangling_filter_reference(a, w)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            if g.dtype != p.dtype or g.shape != p.shape or not torch.equal(bits(g), bits(p)):
                fail(f"dangling_filter {name} differs from its plain version")
            err = max(err, float((g.float() - p.float()).nan_to_num(0.0).abs().max()))
        print(f"[dangling_filter] {name}: bit-equal to the plain version", flush=True)

    for i, ((a, w), _) in enumerate(registry.op_spec("dangling_filter").examples()):
        check(f"example {i} {tuple(a.shape)}", a.to(dev), w.to(dev))
    n = 4099  # 1024 16-byte vectors and a 3-element tail
    a = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)
    w = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)
    a[::5], w[::7] = -0.0, -0.0
    a[1::11], w[2::13] = float("nan"), float("nan")
    a[3::17], w[4::19] = float("inf"), float("-inf")
    a[-3:], w[-3:] = torch.tensor([float("nan"), -0.0, 1.5]), torch.tensor([2.0, 3.0, -0.0])
    a, w = a.to(dev), w.to(dev)
    check(f"-0.0 / NaN / inf, length {n}", a, w)
    check(f"unaligned views, length {n - 1}", a[1:], w[1:])
    check(f"bf16, length {n}", a.to(torch.bfloat16), w.to(torch.bfloat16))
    del a, w
    cgen = torch.Generator(device=dev).manual_seed(0)
    a = torch.relu(torch.randn(DF_SHAPE, device=dev, generator=cgen))
    w = torch.randn(DF_SHAPE, device=dev, generator=cgen)
    w *= torch.rand(DF_SHAPE, device=dev, generator=cgen) > 0.5
    check(f"{DF_SHAPE} fp32", a, w)
    ms = timed(lambda: dangling_filter(a, w), 20)
    plain_ms = timed(lambda: dangling_filter_reference(a, w), 5, warmup=1)
    # two fp32 reads and two fp32 writes per element; two tests, an AND and
    # two selects
    b_ms, b_by = bound(16.0 * a.numel(), 5.0 * a.numel())
    print(f"[dangling_filter] {DF_SHAPE} fp32: kernel {ms:.4f} ms "
          f"({16.0 * a.numel() / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound", flush=True)
    del a, w
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "shape": f"{DF_SHAPE} fp32, ReLU-sparse a, half-sparse w"}


def phase_sweep(dev) -> dict:
    """(7b) the kernel parity sweep, ``bench_kernels.smoke_rows`` on the
    card: every op of the table, its kernel against its plain version on
    every example under the op's compare; counters zeroed just before and
    read just after, every kernel of the sweep must have launched."""
    import torch

    from repro_torch import kernels
    from repro_torch.benchmarks.bench_kernels import smoke_rows

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    rows, failures = smoke_rows(dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    for name, us, worst, route, n in rows:
        print(f"[sweep] {name.split('.')[2]:17s} {route:5s} {n} cases, worst deviation "
              f"{worst:.3g}, {'kernel' if route == 'cuda' else 'plain'} "
              f"{us / 1e3:.4f} ms per case", flush=True)
    print(f"[sweep] {wall:.1f}s, launches {launches}", flush=True)
    for f in failures:
        print(f"[sweep] FAILURE {f}", file=sys.stderr, flush=True)
    if failures:
        fail(f"the kernel sweep failed on {len(failures)} op(s)")
    for name in SWEEP_KERNELS:
        if launches[name] <= 0:
            fail(f"the kernel sweep never launched the {name} kernel")
    return {"rows": [dict(zip(("name", "us_per_case", "worst", "route", "cases"), r))
                     for r in rows], "launches": launches, "wall_s": wall}


def phase_paper(dev) -> dict:
    """(7c) the paper's evaluation path: ``sparsity_probe`` on the card's
    kernels (counters zeroed just before and read just after), then Table 1
    and the Figs. 11-16 geomeans of the model with and without the measured
    skip fractions, beside the paper's."""
    import math

    from repro_torch import kernels
    from repro_torch.benchmarks import bench_paper_figs, bench_table1
    from repro_torch.kernels.masked_matmul.backward import sparsity_probe

    kernels.reset_launch_counts()
    probe = sparsity_probe(density=0.5, size=512, device=dev)
    launches = kernels.launch_counts()
    print(f"[paper] sparsity_probe(density=0.5, size=512) on the card: {probe}; "
          f"launches {launches}", flush=True)
    skips = (probe["forward_tile_skip"], probe["backward_tile_skip"])
    if not all(v is not None and 0.0 <= v < 1.0 for v in skips):
        fail(f"sparsity_probe measured no valid skip fraction: {probe}")
    for name in PAPER_KERNELS:
        if launches[name] <= 0:
            fail(f"sparsity_probe never launched the {name} kernel")
    table1 = bench_table1.rows()
    print("[paper] Table 1: " + ", ".join(f"{n.split('.')[1]} {v:g}" for n, _, v in table1),
          flush=True)

    def geomeans(rows, tag):
        return {n.rsplit(".", 1)[0]: v for n, _, v in rows if n.endswith("." + tag)}

    analytic = bench_paper_figs.rows()
    measured = bench_paper_figs.rows(compute_skip_fraction=skips[0],
                                     backward_skip_fraction=skips[1])
    model, grounded = geomeans(analytic, "GEOMEAN"), geomeans(measured, "GEOMEAN")
    paper = geomeans(analytic, "PAPER_GEOMEAN")
    for fig in model:
        print(f"[paper] {fig} geomean: model {model[fig]:.4f}, with the measured skips "
              f"{grounded[fig]:.4f}, paper {paper[fig]:g}", flush=True)
    if not all(math.isfinite(v) and v > 0 for v in (*model.values(), *grounded.values())):
        fail("the paper figures' geomeans are not finite and positive")
    return {"probe": probe, "launches": launches, "table1": {n: v for n, _, v in table1},
            "geomean_model": model, "geomean_measured_skips": grounded, "geomean_paper": paper,
            "rows_measured_skips": [list(r) for r in measured]}


# -- 8. the mesh: packed collectives, sharded training and serving, the pipeline

MESH_SERVE_SETS = ("arch.id=llama3.2-1b", "arch.reduced=false", "numerics.mode=quant_sparse",
                   "serving.static=true", "shape.batch=8", "shape.prompt_len=32",
                   "shape.gen=16")
# one step (3 before 8g, 2 before 8i), its parameters held bit for bit against the unsharded
# step's (the exchanged gradient's whole effect), as a second step's loss held them
MESH_TRAIN_SETS = ("arch.reduced=false", "train.steps=1", "train.ckpt_dir=")
MESH_TRAIN_DATA = 2  # two full-width replicas fit the card beside the exchange, four do not
MESH_SERVE_DATA = 4
MESH_POD_STEPS = 1
MESH_POD_SAMPLE = 1 << 20  # elements of each leaf whose pods' true mean is gathered
MESH_CHECK_CHUNK = 1 << 26  # elements of a parameter leaf checksummed at once
MESH_PAYLOAD = 1 << 26  # elements a rank contributes: dist.train's gradient chunk
MESH_PAYLOADS = ((1.0, "float32"), (0.5, "float32"), (0.1, "float32"), (0.5, "bfloat16"))
MESH_PIPE = dict(stages=4, micro=6, rows=64)  # rows of a microbatch (the tile kernel)
MESH_TIMEOUT_S = 600
MESH_COLLECTIVE_TIMEOUT_S = 300
MESH_SERVE_KERNELS = ("masked_matmul", "masked_matmul_skinny", "tile_occupancy", "mask_pack")
MESH_TRAIN_KERNELS = ("masked_matmul", "tile_occupancy", "stochastic_round", "mask_pack")
# 8e / 8f: tensor parallelism, llama3.2-1b's weights over model = 4
MESH_TP = 4
MESH_TP_TRAIN_SETS = ("arch.reduced=false", "numerics.stochastic=off", "train.steps=2",
                      "train.ckpt_dir=")
MESH_TP_TRAIN_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw",
                         "tile_occupancy", "stochastic_round")
MESH_TP_SERVE_KERNELS = ("masked_matmul", "masked_matmul_skinny", "tile_occupancy",
                         "flash_attention")
MESH_TP_LOSS_RTOL = 1e-4
MESH_TP_LOGIT_ATOL = 1e-3
MESH_UNSHARDED_PEAK_GIB = 20.83  # phase 5f's unsharded peak (PERF.md section 4)
# 8g: the engines at model = 4 on phase 3's traffic (4 slots, 6 requests of prompt 32;
# gen cut from 16 to 8 for the time limit): monolithic (a snapshot at MESH_TP_SNAPSHOT_TICK,
# while the first four requests decode and two wait), paged with a shared
# MESH_TP_SYSTEM-token system prompt, and monolithic pruned at MESH_TP_PRUNE through
# the ServeSession.  At prompt 32 every product has M <= 32: the skinny kernel alone
MESH_TP_ENGINE_SETS = ("arch.id=llama3.2-1b", "arch.reduced=false",
                       "numerics.mode=quant_sparse", "shape.batch=4", "serving.queue=6",
                       "shape.prompt_len=32", "shape.gen=8")
MESH_TP_ENGINE_KERNELS = ("masked_matmul_skinny", "flash_attention", "mask_pack")
MESH_TP_SYSTEM = 16
MESH_TP_SNAPSHOT_TICK = 4
MESH_TP_PRUNE = 0.5
MESH_TP_ENGINE_RUNS = ("mono", "paged", "pruned")
# 8h: expert parallelism at model = 4, in 8e-8g's spawn after 8g.  Full-width olmoe-1b-7b
# (64 experts, 16 a rank; 16 kv heads, 4 a rank) and deepseek-v2-lite-16b (64 routed and
# 2 shared experts; MLA's 16 heads, 4 a rank; its latent pool whole on every rank) served on
# 6k's traffic through the monolithic engine, their tokens held against 6k's unsharded ones;
# olmoe-1b-7b trained from the example spec (nearest rounding, batch 8, seq 128, 2 steps) at
# MESH_EP_TRAIN_UNITS of its 16 layers, against the same run unsharded in the parent
MESH_EP_UNITS = {"olmoe-1b-7b": 16, "deepseek-v2-lite-16b": 26}
MESH_EP_TRAIN_UNITS = 4
MESH_EP_TRAIN_SETS = ("arch.id=olmoe-1b-7b", *MESH_TP_TRAIN_SETS)
MESH_EP_HEADROOM = 4 * 2**30
MESH_EP_ROUTER_TIE = 1e-5
MESH_EP_SERVE_KERNELS = {"olmoe-1b-7b": ("masked_matmul", "masked_matmul_skinny",
                                         "tile_occupancy", "mask_pack", "flash_attention"),
                         "deepseek-v2-lite-16b": ("masked_matmul", "masked_matmul_skinny",
                                                  "tile_occupancy", "mask_pack")}
MESH_EP_TRAIN_KERNELS = MESH_TP_TRAIN_KERNELS
# 8i: the SSM and RG-LRU blocks at model = 4, in 8e-8h's spawn after 8h.  Full-width
# mamba2-780m (48 layers; 48 SSM heads, 12 a rank; in_proj's 6,448 columns 1,612 a rank,
# gathered whole) and recurrentgemma-9b (38 layers; the RG-LRU's 4,096 channels, 1,024 a rank;
# the local attention's 16 heads, 4 a rank on the one kv head) served on the monolithic engine
# at MESH_SSM_TRAFFIC against the same runs unsharded in the parent; mamba2 trained whole and
# recurrentgemma at MESH_SSM_TRAIN_UNITS unit + its 2 suffix layers from the example spec
# (nearest rounding, batch 8, seq 128, 2 steps) against their unsharded runs in the parent
MESH_SSM_ARCHS = ("mamba2-780m", "recurrentgemma-9b")
MESH_SSM_TRAFFIC = (4, 512, 8, 512 + 8 + 2)  # requests (= slots), prompt, gen, max_len
MESH_SSM_TRAIN_UNITS = {"mamba2-780m": 48, "recurrentgemma-9b": 1}
MESH_SSM_SERVE_KERNELS = {"mamba2-780m": ("masked_matmul", "masked_matmul_skinny",
                                          "tile_occupancy", "ssd_scan"),
                          "recurrentgemma-9b": ("masked_matmul", "masked_matmul_skinny",
                                                "tile_occupancy", "mask_pack",
                                                "flash_attention")}
MESH_SSM_TRAIN_KERNELS = {"mamba2-780m": (*MESH_TP_TRAIN_KERNELS, "ssd_scan"),
                          "recurrentgemma-9b": MESH_TP_TRAIN_KERNELS}
#: 8h's check names under 8e's (the kernel line's mesh_tp errors)
EP_CHECK_KEYS = {"masked_matmul": "forward", "masked_matmul_skinny": "skinny",
                 "masked_matmul_dx": "dx", "masked_matmul_dw": "dw"}


def _mesh_rank_setup(world: int, device: str, axis: str = "data"):
    """A phase-8 rank: TF32 off, its mesh over the launcher's gloo group on
    ``device`` (on the card every rank shares cuda:0), the ranks along
    ``axis``, its peak memory counted anew.  ``device="cpu"`` rehearses the
    phase at a small size."""
    import os

    import torch

    from repro_torch.dist.mesh import make_explicit_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    mesh = make_explicit_mesh(1, *((world, 1) if axis == "data" else (1, world)), device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    return mesh


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev) -> None:
    """Hand a rank's freed blocks back to the card the ranks share."""
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _leaf_checksums(leaves, dev):
    """``(len(leaves), 2)`` int64: each leaf's bit patterns summed, plain and
    weighted by position mod 257, over chunks of MESH_CHECK_CHUNK elements.
    Two ranks whose checksums agree hold the same bits, short of a
    collision, without a whole model crossing the wire."""
    import torch

    out = torch.zeros(len(leaves), 2, dtype=torch.int64, device=dev)
    for i, p in enumerate(leaves):
        flat = p.detach().reshape(-1)
        bits = flat.view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                          1: torch.int8}[flat.element_size()])
        for s in range(0, bits.numel(), MESH_CHECK_CHUNK):
            b = bits[s:s + MESH_CHECK_CHUNK].to(torch.int64)
            w = torch.arange(s, s + b.numel(), device=dev) % 257 + 1
            out[i, 0] += b.sum()
            out[i, 1] += (b * w).sum()
    return out


def _mesh_payload(seed: int, d: int, n: int, density: float, dtype, dev):
    """A stacked (d, n) payload made on the card from a seed (every rank
    makes the same one): normals, each kept with probability ``density``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((d, n), generator=gen, device=dev)
    keep = torch.rand((d, n), generator=gen, device=dev) < density
    return torch.where(keep, x, 0.0).to(dtype)


def mesh_rank_four(rank: int, world: int, serve_sets: tuple, device: str = "cuda",
                   payload: int = MESH_PAYLOAD, mlp: tuple = LAYER_SHAPES["up"]) -> dict:
    """(8a, 8c, 8d) on one of four ranks: the collectives at the gradient
    chunk's size, llama3.2-1b served with its rows over ``data``, and the
    pipeline over ``pod``."""
    import torch

    from repro_torch import kernels
    from repro_torch.api import ServeSession, build_spec
    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.core.spring_ops import MODES, spring_matmul
    from repro_torch.dist import collectives as C
    from repro_torch.dist.mesh import Mesh
    from repro_torch.kernels.mask_compress.ops import mask_pack_reference, pack_words
    from repro_torch.runtime.pipeline import pipeline_apply, stack_stage_params
    from repro_torch.runtime.sharding import sharding_context

    t_rank = time.monotonic()
    mesh = _mesh_rank_setup(world, device)
    dev = mesh.device
    out: dict = {"backend": mesh.backend}

    # -- a. collective mode = simulation mode on card tensors -----------------------
    rows = []
    with sharding_context(mesh):
        for i, (density, dtype) in enumerate(MESH_PAYLOADS):
            x = _mesh_payload(10 + i, world, payload, density, getattr(torch, dtype), dev)
            sim = C.packed_all_gather(x)
            _sync(dev)
            t0 = time.monotonic()
            got = C.packed_all_gather(x[rank], axis_name="data")
            _sync(dev)
            ms = (time.monotonic() - t0) * 1e3
            words_ok = torch.equal(pack_words(x[rank]), mask_pack_reference(x[rank]))
            nnz = int(torch.count_nonzero(x))
            wire = C.collective_wire_bits(nnz, payload, world) / 8.0
            row = {"density": density, "dtype": dtype, "equal": torch.equal(got, sim),
                   "mask_pack_equal": words_ok, "nnz": nnz, "wire_bytes": wire,
                   "compression_vs_fp32": world * payload * 4.0 / wire, "ms": ms}
            if i == 1:
                rs = C.packed_reduce_scatter(x[rank], axis_name="data")
                row["reduce_scatter_equal"] = torch.equal(rs, C.packed_reduce_scatter(x)[rank])
                del rs
            rows.append(row)
            del x, sim, got
            _free(dev)
    out["collectives"] = rows

    # -- c. sharded serving: the static path, rows over data ---------------------------
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    sv = ServeSession(build_spec("serve", sets=[*serve_sets, f"shape.mesh.data={world}"]),
                      device=dev, mesh=mesh).run()
    _sync(dev)
    out["serve"] = {"generated": sv["generated"].tolist(), "prefill_s": sv["prefill_s"],
                    "decode_s": sv["decode_s"], "tokens_per_s": sv["tokens_per_s"],
                    "finite": sv["finite"], "probe": sv["collective_probe"],
                    "wall_s": time.monotonic() - t0, "launches": kernels.launch_counts()}
    del sv
    _free(dev)

    # -- d. the pipeline: 4 stages of one llama3.2-1b MLP's two products ---------------
    pipe_mesh = Mesh(world, 1, 1, device=dev)
    spring = dataclasses.replace(MODES["quant_sparse"], stochastic=False)
    gen = torch.Generator(device=dev).manual_seed(8)
    d, ff = mlp
    per_stage = [{"up": quantize_nearest(torch.randn((d, ff), generator=gen, device=dev) / d**0.5),
                  "down": quantize_nearest(torch.randn((ff, d), generator=gen, device=dev)
                                           / ff**0.5)} for _ in range(MESH_PIPE["stages"])]
    xs = quantize_nearest(torch.randn((MESH_PIPE["micro"], MESH_PIPE["rows"], d), generator=gen,
                                      device=dev))

    def stage_fn(h, p):
        return spring_matmul(spring_matmul(h, p["up"], spring), p["down"], spring)

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    got = pipeline_apply(stage_fn, stack_stage_params(per_stage), xs, mesh=pipe_mesh, axis="pod")
    _sync(dev)
    pipe_ms = (time.monotonic() - t0) * 1e3
    pipe_launches = kernels.launch_counts()
    want, h_last = xs, None
    for p in per_stage:
        h_last = torch.stack([spring_matmul(m, p["up"], spring) for m in want])
        want = torch.stack([spring_matmul(m, p["down"], spring) for m in h_last])
    tol = 2 * ff * 2.0**-24 * torch.stack([m.abs() @ per_stage[-1]["down"].abs()
                                           for m in h_last])
    err = (got - want).abs()
    out["pipeline"] = {"max_abs_err": float(err.max()), "within": bool((err <= tol).all()),
                       "equal": torch.equal(got, want), "ms": pipe_ms,
                       "launches": pipe_launches}
    out["staged_hops"] = mesh.staged_hops + pipe_mesh.staged_hops
    out["peak_gib"] = _peak_gib(dev)
    out["wall_s"] = time.monotonic() - t_rank
    return out


def mesh_rank_two(rank: int, world: int, spec_path: str, train_sets: tuple,
                  device: str = "cuda") -> dict:
    """(8b) on one of two ranks: llama3.2-1b trained at data=2 through the
    TrainSession, then at pod=2 with compress_pod_grads (4 rows a pod), the
    int8 + EF contract checked after its first step and both pods'
    parameters held bit for bit after the last (the step's own exchange of
    int8 payloads and scales must hand every rank the same mean)."""
    import torch

    from repro_torch import kernels
    from repro_torch.api import TrainSession, build_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.dist.mesh import Mesh
    from repro_torch.kernels.prng import fold_in
    from repro_torch.launch.train import on_grid
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.compression import dequantize_int8, sr_quantize_int8
    from repro_torch.runtime.train import POD_SEED_FOLD, init_train_state, make_train_step

    t_rank = time.monotonic()
    mesh = _mesh_rank_setup(world, device)
    dev = mesh.device
    out: dict = {"backend": mesh.backend}

    # -- data = 2: the packed gradient exchange -----------------------------------------
    spec = build_spec("train", spec_file=spec_path, sets=[*train_sets,
                                                          f"shape.mesh.data={world}"])
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    tr = TrainSession(spec, device=dev, mesh=mesh).run()
    _sync(dev)
    out["data"] = {"losses": tr["losses"], "probe": tr["collective_probe"],
                   "grid": on_grid(dict(enumerate(tree_leaves(tr["state"].params)))),
                   "sums": _leaf_checksums(tree_leaves(tr["state"].params), dev).cpu(),
                   "wall_s": time.monotonic() - t0, "launches": kernels.launch_counts(),
                   "staged_hops": mesh.staged_hops, "peak_gib": _peak_gib(dev)}
    del tr
    _free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # -- pod = 2: compress_pod_grads, the int8 + EF link ----------------------------------
    pod_mesh = Mesh(world, 1, 1, device=dev)
    r = build_spec("train", spec_file=spec_path, sets=list(train_sets)).resolve()
    step_cfg = dataclasses.replace(r.step, compress_pod_grads=True)
    seed = r.spec.seeds.seed
    state = init_train_state(r.view, step_cfg, seed, device=dev)
    captured: dict = {}

    def capture(grads):  # the pod's own gradients, as they enter the exchange
        captured["grads"] = grads
        return grads

    step = make_train_step(r.view, step_cfg, mesh=pod_mesh, grad_sync=capture)
    data = SyntheticLMStream(DataConfig(seed=seed, vocab=r.config.vocab, seq_len=r.spec.shape.seq,
                                        global_batch=r.spec.shape.batch), device=dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    losses, ef_exact, ef_worst, worst = [], True, 0.0, 0.0
    for i in range(MESH_POD_STEPS):
        state, metrics = step(state, {"tokens": data.batch(i)})
        losses.append(float(metrics["loss"]))
        if i:
            continue
        # step 0 started from zero EF buffers: local = the pod's gradient.
        # On every element: ef = local - dequant exactly and |ef| <= scale,
        # so the exchanged mean (the pods' dequantized payloads averaged) is
        # within one step of the true mean; on each leaf's first
        # MESH_POD_SAMPLE elements the exchange's formula is held against the
        # true mean directly (gathering whole fp32 gradients over gloo would
        # take longer than the phase)
        pod_seed = fold_in(fold_in(seed, 0), POD_SEED_FOLD)
        for j, (g, e) in enumerate(zip(tree_leaves(captured["grads"]), tree_leaves(state.ef))):
            q, scale = sr_quantize_int8(g, fold_in(pod_seed, j))
            deq = dequantize_int8(q, scale)
            ef_exact &= torch.equal(e, g.float() - deq)
            ef_worst = max(ef_worst, float(e.abs().max() / scale))
            n = min(g.numel(), MESH_POD_SAMPLE)
            scales = pod_mesh.all_gather(scale, "pod")
            qs = pod_mesh.all_gather(q.reshape(-1)[:n], "pod").to(torch.float32)
            mean = torch.tensordot(scales, qs, dims=([0], [0])) / pod_mesh.axis_size("pod")
            true = pod_mesh.all_gather(g.float().reshape(-1)[:n], "pod").mean(0)
            worst = max(worst, float((mean - true).abs().max() / scales.max()))
            del q, deq, qs
        captured.clear()
        _free(dev)
    _sync(dev)
    launches = kernels.launch_counts()  # the checks' exchanges launch no kernel
    sums = pod_mesh.all_gather(_leaf_checksums(tree_leaves(state.params), dev), "pod")
    out["pod"] = {"losses": losses, "ef_exact": ef_exact, "ef_worst_over_step": ef_worst,
                  "worst_err_over_step": worst, "params_same": bool((sums == sums[0]).all()),
                  "grid": on_grid(dict(enumerate(tree_leaves(state.params)))),
                  "wall_s": time.monotonic() - t0, "launches": launches,
                  "peak_gib": _peak_gib(dev)}
    out["staged_hops"] = mesh.staged_hops + pod_mesh.staged_hops
    out["wall_s"] = time.monotonic() - t_rank
    return out


def _tp_kernel_checks(dev, cfg, model: int, rank: int, batch: int, seq: int,
                      prompt: int) -> dict:
    """8e / 8f's path kernels on this rank, at the shard shapes its runs gave
    them, against their plain versions: the masked_matmul forward (tile
    and skinny), dx, dw, tile_occupancy, splitk_reduce and stochastic_round
    through phase 5f's check on a config of one rank's shards (wq 2048x512,
    wk / wv 2048x128, wo 512x2048, gate / up 2048x2048, down 2048x2048, the
    embedding's 32064 vocabulary rows), the strided stochastic_round on
    this rank's wq shard bit-equal, and flash_attention on its heads (B
    ``batch``, H 8, HKV 2, D 64) at S ``prompt`` (8f's prefill) and ``seq``
    (8e's length)."""
    import types

    import torch

    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention
    from repro_torch.kernels.stochastic_round.ops import (shard_counter, sr_reference,
                                                          stochastic_round)
    from repro_torch.models.attention import AttnSpec

    a = cfg.attn
    local = types.SimpleNamespace(
        attn=AttnSpec(n_heads=a.n_heads // model, n_kv_heads=a.n_kv_heads // model,
                      head_dim=a.head_dim),
        d_model=cfg.d_model, d_ff=cfg.d_ff // model, vocab=cfg.vocab // model)
    errs = _train_lm_kernel_checks(dev, local, batch, seq, phase=f"mesh_tp rank {rank}")
    g = torch.Generator(device=dev).manual_seed(40 + rank)
    d, cols = cfg.d_model, a.n_heads * a.head_dim
    w = torch.randn(d, cols // model, generator=g, device=dev)
    base, stride = shard_counter((d, cols), 1, rank * (cols // model))
    if not torch.equal(stochastic_round(w, 3, base=base, row_stride=stride),
                       sr_reference(w, 3, base=base, row_stride=stride)):
        fail(f"mesh_tp rank {rank}: the strided stochastic_round on its wq shard "
             f"{tuple(w.shape)} differs from its plain version")
    fa, la = 0.0, local.attn
    for s_len in (prompt, seq):
        q = torch.randn(batch, s_len, la.n_heads, la.head_dim, generator=g,
                        device=dev).transpose(1, 2)
        k, v = (torch.randn(batch, s_len, la.n_kv_heads, la.head_dim, generator=g,
                            device=dev).transpose(1, 2) for _ in range(2))
        e = _max_err(flash_attention(q, k, v), attention_reference(q, k, v))
        if not e <= 2e-5:
            fail(f"mesh_tp rank {rank}: flash_attention ({batch},{la.n_heads},{la.n_kv_heads},"
                 f"{s_len},{la.head_dim}) off by {e:.3g}")
        fa = max(fa, e)
    errs["flash_attention"] = fa
    torch.cuda.empty_cache()
    return errs


def _tp_engine_prompts(spec, vocab: int) -> tuple:
    """8g's prompts: the engine session's synthetic ones, and the same with
    their first MESH_TP_SYSTEM tokens replaced by one shared system prompt."""
    from repro_torch.api.sessions import synthetic_prompts

    n = spec.serving.queue
    prompts = synthetic_prompts(n, spec.shape.batch, spec.shape.prompt_len, vocab,
                                spec.seeds.seed)
    system = prompts[0][:MESH_TP_SYSTEM]
    return prompts, [system + p[MESH_TP_SYSTEM:] for p in prompts]


def _pool_parts(eng) -> dict:
    """The bytes of an engine's KV storage by part: packed values, mask
    words and per-block nnz counts (the paged store's frames, or the
    monolithic pool's leaves), and its dense state leaves."""
    from repro_torch.serving import kvpool

    out = dict.fromkeys(("values", "mask", "nnz", "state"), 0)
    if hasattr(eng, "store_arrays"):
        for arrays in eng.store_arrays.values():
            for part in ("values", "mask", "nnz"):
                out[part] += arrays[part].numel() * arrays[part].element_size()
        out["state"] = sum(t.numel() * t.element_size() for t in kvpool.pool_leaves(eng.state))
        return out
    for unit in (k for k in eng.pool if k != "pos"):
        for leaf in eng.pool[unit].values():
            for part in ("values", "mask", "nnz"):
                t = getattr(leaf, part)
                out[part] += t.numel() * t.element_size()
    out["state"] = eng.pool["pos"].numel() * eng.pool["pos"].element_size()
    return out


def _pool_blocks(eng) -> tuple:
    """(lead dims, block length) of an engine's packed KV blocks: a
    monolithic pool leaf's (layers, slots), or a page array's (layers,
    frames)."""
    if hasattr(eng, "store_arrays"):
        v = next(iter(eng.store_arrays.values()))["values"]
    else:
        v = next(iter(eng.pool[next(k for k in eng.pool if k != "pos")].values())).values
    return tuple(v.shape[:-1]), int(v.shape[-1])


def _engine_gaps(eng, first_logits: bool = False) -> dict:
    """Record an engine's top-2 logit gaps as it runs: each request's
    prefill, and each decode tick's per slot (8g's near-tie rule).  The
    step running is ``rec["at"]``: ``("prefill", rid)`` or ``("decode",
    tick)`` (:func:`_moe_routing` files its records under it); with
    ``first_logits``, also each request's prefill logits (8h's rule)."""
    rec = {"prefill": {}, "decode": {}, "rid": None, "at": None, "first_logits": {},
           "routing": {}}
    admit, prefill, decode = eng._admit_one, eng._prefill, eng._decode

    def gap(logits):
        top = logits.float().topk(2, dim=-1).values
        return (top[..., 0] - top[..., 1]).cpu()

    def admit_one(tracker):
        rec["rid"] = tracker.req.rid
        rec["at"] = ("prefill", tracker.req.rid)
        return admit(tracker)

    def prefill_step(*args, **kw):
        logits, cache = prefill(*args, **kw)
        rec["prefill"][rec["rid"]] = float(gap(logits)[0])
        if first_logits:
            rec["first_logits"][rec["rid"]] = logits[0].float().cpu()
        return logits, cache

    def decode_step(*args):
        rec["at"] = ("decode", eng.tick)
        logits, cache = decode(*args)
        rec["decode"][eng.tick] = gap(logits)
        return logits, cache

    eng._admit_one, eng._prefill, eng._decode = admit_one, prefill_step, decode_step
    return rec


def _token_gaps(eng, out: dict, rec: dict) -> list:
    """Per request, per emitted token, the unsharded top-2 gap behind it
    (the first token's also its prefill's): token i of a request comes from
    the decode tick first_token_tick + i, in its slot."""
    gaps = []
    for r in out["per_request"]:
        slot, t0 = eng._results[r["rid"]].slot, r["first_token_tick"]
        row = [float(rec["decode"][t0 + i][slot]) for i in range(len(r["tokens"]))]
        if row:
            row[0] = min(row[0], rec["prefill"][r["rid"]])
        gaps.append(row)
    return gaps


def _tp_engine_run(name: str, spec, params, prompts, dev, mesh=None, snap_path=None,
                   prune: float = 0.0, gaps: bool = False) -> dict:
    """One of 8g's runs of ``spec`` (monolithic or paged by its
    serving.pages) on ``params`` (the rank's shards under ``mesh``, or the
    whole), the counters zeroed just before and read just after.  With
    ``snap_path`` the run snapshots at tick MESH_TP_SNAPSHOT_TICK (every
    rank; rank 0 writes the file) and goes on; ``gaps`` records the
    unsharded run's top-2 gaps (8g's near-tie rule)."""
    import torch

    from repro_torch import kernels
    from repro_torch.dist.mesh import is_rank0
    from repro_torch.serving import elastic
    from repro_torch.serving.engine import ServingEngine

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    hops = mesh.hops.get("model", 0) if mesh is not None else 0
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    eng = ServingEngine.from_spec(spec, params=params, prune_ratio=prune, device=dev, mesh=mesh)
    rec = _engine_gaps(eng) if gaps else None
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, spec.shape.gen, seed=spec.seeds.seed + i)
    if snap_path is not None:
        while eng.tick < MESH_TP_SNAPSHOT_TICK:
            eng.step()
        snap = eng.snapshot()
        if is_rank0():
            elastic.save_snapshot(snap, snap_path)
        del snap
    out = eng.run()
    _sync(dev)
    res = {"tokens": [r["tokens"] for r in out["per_request"]], "ticks": out["ticks"],
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "tokens_per_s": out["tokens_per_s"], "finite": out["finite"],
           "wall_s": time.monotonic() - t0, "launches": kernels.launch_counts(),
           "model_hops": (mesh.hops.get("model", 0) - hops) if mesh is not None else 0,
           "peak_gib": _peak_gib(dev), "pool": _pool_parts(eng), "blocks": _pool_blocks(eng),
           "kv_heads": None if eng.heads is None else list(eng.heads.mine),
           "wire": {k: out[k] for k in ("kv_mean_wire_bytes", "kv_mean_density",
                                        "peak_kv_wire_bytes")}}
    if gaps:
        res["gaps"] = _token_gaps(eng, out, rec)
    del eng, out
    _free(dev)
    return res


def _tp_engine_runs(mesh, dev, world: int, snap_path: str) -> dict:
    """8g on one rank: the three engine runs at model = ``world``; the
    monolithic and paged ones from the rank's shards (drawn once, leaf by
    leaf), the pruned one through the ServeSession, which draws its own."""
    import torch

    from repro_torch import kernels
    from repro_torch.api import ServeSession, build_spec
    from repro_torch.models.lm import lm_init

    spec = build_spec("serve", sets=[*MESH_TP_ENGINE_SETS, f"shape.mesh.model={world}"])
    cfg = spec.resolve().config
    prompts, shared = _tp_engine_prompts(spec, cfg.vocab)
    params = lm_init(cfg, spec.seeds.seed, device=dev, mesh=mesh)
    out = {"mono": _tp_engine_run("mono", spec, params, prompts, dev, mesh, snap_path),
           "paged": _tp_engine_run("paged", build_spec("serve", sets=[
               *MESH_TP_ENGINE_SETS, f"shape.mesh.model={world}", "serving.pages=true"]),
               params, shared, dev, mesh)}
    del params
    _free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    hops = mesh.hops.get("model", 0)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    sv = ServeSession(spec, device=dev, mesh=mesh, prune_ratio=MESH_TP_PRUNE).run()
    _sync(dev)
    out["pruned"] = {"tokens": [r["tokens"] for r in sv["per_request"]], "ticks": sv["ticks"],
                     "prefill_s": sv["prefill_s"], "decode_s": sv["decode_s"],
                     "tokens_per_s": sv["tokens_per_s"], "finite": sv["finite"],
                     "wall_s": time.monotonic() - t0, "launches": kernels.launch_counts(),
                     "model_hops": mesh.hops.get("model", 0) - hops,
                     "peak_gib": _peak_gib(dev), "report": sv["tensor_parallel"]}
    del sv
    _free(dev)
    return out


def _tp_engine_checks(dev, cfg, model: int, rank: int, engine: dict) -> dict:
    """8g's path kernels on this rank at the engine's shard shapes, against
    their plain versions: the skinny masked_matmul at the decode's M =
    DECODE_M on the seven projections' shards (unpruned and pruned at
    MESH_TP_PRUNE), flash_attention on one request's prefill (B 1, the
    rank's heads, S the prompt), and mask_pack (through kv_pack) bit-equal
    on blocks of the rank's pool leaf and of its pages."""
    import torch

    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention
    from repro_torch.kernels.kv_cache.ops import kv_pack, kv_pack_reference
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_reference
    from repro_torch.models.layers import SpringContext

    g = torch.Generator(device=dev).manual_seed(70 + rank)
    a, d = cfg.attn, cfg.d_model
    hl, kvl, hd = a.n_heads // model, a.n_kv_heads // model, a.head_dim
    projs = ((d, hl * hd), (d, kvl * hd), (hl * hd, d), (d, cfg.d_ff // model),
             (cfg.d_ff // model, d))
    skinny = 0.0
    for prune in (0.0, MESH_TP_PRUNE):
        cut = SpringContext(prune_ratio=prune).maybe_prune
        for k, n in projs:
            x = quantize_nearest(torch.randn(DECODE_M, k, generator=g, device=dev))
            w = cut(quantize_nearest(torch.randn(k, n, generator=g, device=dev) * k**-0.5))
            bnd = (x.abs() @ w.abs()).mul_(2 * k * 2.0**-24)
            err = (masked_matmul(x, w, apply_sr=False)
                   - masked_matmul_reference(x, w, apply_sr=False)).abs_()
            if not bool((err <= bnd).all()):
                fail(f"mesh_tp rank {rank}: 8g skinny masked_matmul ({DECODE_M},{k})x({k},{n}) "
                     f"off by {float(err.max()):.3g}")
            skinny = max(skinny, float(err.max()))
    prompt = engine["prompt"]
    q = torch.randn(1, prompt, hl, hd, generator=g, device=dev).transpose(1, 2)
    k_, v_ = (torch.randn(1, prompt, kvl, hd, generator=g, device=dev).transpose(1, 2)
              for _ in range(2))
    fa = _max_err(flash_attention(q, k_, v_, causal=True),
                  attention_reference(q, k_, v_, causal=True))
    if not fa <= 2e-5:
        fail(f"mesh_tp rank {rank}: 8g flash_attention (1,{hl},{kvl},{prompt},{hd}) off by {fa:.3g}")
    for lead, block in engine["blocks"]:
        x = torch.randn(*lead, block, generator=g, device=dev)
        x = torch.where(torch.rand(*lead, block, generator=g, device=dev) < 0.5, x, 0.0)
        x = x.to(torch.bfloat16)
        got, want = kv_pack(x), kv_pack_reference(x)
        if not all(torch.equal(got[p].view(torch.int32) if p == "mask" else got[p],
                               want[p].view(torch.int32) if p == "mask" else want[p])
                   for p in ("values", "mask", "nnz")):
            fail(f"mesh_tp rank {rank}: 8g mask_pack on the pool's {tuple(lead)} x {block} "
                 "blocks differs from its plain version")
    torch.cuda.empty_cache()
    print(f"[mesh_tp rank {rank}] 8g kernels at the engine's shard shapes: skinny M {DECODE_M} "
          f"(pruned at {MESH_TP_PRUNE} too) {skinny:.3g}, flash_attention (1,{hl},{kvl},"
          f"{prompt},{hd}) {fa:.3g}, mask_pack bit-equal on {[tuple(b) for b in engine['blocks']]}",
          flush=True)
    return {"skinny": skinny, "flash_attention": fa, "mask_pack": 0.0}


def mesh_rank_tp(rank: int, world: int, spec_path: str, train_sets: tuple, serve_sets: tuple,
                 snap_path: str = "", ep: bool = False, ssm: bool = False,
                 device: str = "cuda") -> dict:
    """(8e, 8f) on one of ``world`` ranks at shape.mesh.model = world: the
    example train spec through the TrainSession (then one more step timed
    alone), then static serving through the ServeSession; each run's
    counters zeroed just before it and read just after; the first step's
    logits through the same sharded prefill; then 8g's engines and (on the
    card) the path kernels at their shard shapes; with ``ep``, then 8h
    (:func:`_ep_runs`) once llama3.2-1b's shards are freed; with ``ssm``,
    then 8i (:func:`_ssm_runs`)."""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.api import ServeSession, TrainSession, build_spec
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import on_grid
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_init, lm_prefill
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.train import make_train_step
    from repro_torch.runtime.tree_sharding import param_splits

    t_rank = time.monotonic()
    mesh = _mesh_rank_setup(world, device, axis="model")
    dev = mesh.device
    out: dict = {"backend": mesh.backend}

    # -- e. training at model = world --------------------------------------------------------
    spec = build_spec("train", spec_file=spec_path, sets=[*train_sets,
                                                          f"shape.mesh.model={world}"])
    r = spec.resolve()
    with sharding_context(mesh):  # the bytes a rank must hold: its shards, the rest whole
        want_bytes = sum(4 * (math.prod(sp.full) // world) for sp in
                         tree_leaves(param_splits(r.config, mesh)) if sp is not None)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    tr = TrainSession(spec, device=dev, mesh=mesh).run()
    _sync(dev)
    wall, launches = time.monotonic() - t0, kernels.launch_counts()
    state, rep, losses = tr["state"], tr["tensor_parallel"], tr["losses"]
    del tr
    whole = sum(4 * p.numel() for p in tree_leaves(state.params) if p.ndim == 1)
    # one more step alone, timed (the session's wall holds the init and the shard)
    step = make_train_step(r.view, r.step, mesh=mesh)
    data = SyntheticLMStream(DataConfig(seed=spec.seeds.seed, vocab=r.config.vocab,
                                        seq_len=spec.shape.seq, global_batch=spec.shape.batch),
                             device=dev)
    batch = {"tokens": data.batch(spec.train.steps)}
    hops, staged = mesh.hops.get("model", 0), mesh.staged_hops
    _sync(dev)
    t0 = time.monotonic()
    state, metrics = step(state, batch)
    extra_loss = float(metrics["loss"])
    _sync(dev)
    step_s = time.monotonic() - t0
    out["train"] = {
        "losses": losses, "extra_loss": extra_loss, "wall_s": wall, "step_s": step_s,
        "tokens_per_s": spec.shape.batch * spec.shape.seq / step_s, "launches": launches,
        "report": rep, "param_bytes_want": want_bytes + whole,
        "grid": on_grid(dict(enumerate(tree_leaves(state.params)))),
        "step_model_hops": mesh.hops.get("model", 0) - hops,
        "step_staged_hops": mesh.staged_hops - staged, "peak_gib": _peak_gib(dev)}
    del state, step, metrics, batch
    _free(dev)

    # -- f. static serving at model = world --------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sspec = build_spec("serve", sets=[*serve_sets, f"shape.mesh.model={world}"])
    hops, staged = mesh.hops.get("model", 0), mesh.staged_hops
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    sv = ServeSession(sspec, device=dev, mesh=mesh).run()
    _sync(dev)
    out["serve"] = {"generated": sv["generated"].tolist(), "prefill_s": sv["prefill_s"],
                    "decode_s": sv["decode_s"], "tokens_per_s": sv["tokens_per_s"],
                    "finite": sv["finite"], "wall_s": time.monotonic() - t0,
                    "launches": kernels.launch_counts(), "report": sv["tensor_parallel"],
                    "model_hops": mesh.hops.get("model", 0) - hops,
                    "staged_hops": mesh.staged_hops - staged, "peak_gib": _peak_gib(dev)}
    del sv
    _free(dev)
    # the first step's logits, through the same sharded prefill (for 8f's gate)
    sr = sspec.resolve()
    params = lm_init(sr.config, sspec.seeds.seed, device=dev, mesh=mesh)
    with sharding_context(mesh):
        tokens = _serve_tokens(sspec, sr.config, dev)
        with torch.no_grad():
            logits, _ = lm_prefill(params, sr.config, tokens, SpringContext(cfg=sr.spring))
    out["first_logits"] = logits.cpu()
    del params, logits
    _free(dev)

    # -- g. the engines at model = world --------------------------------------------------
    t0 = time.monotonic()
    out["engine"] = _tp_engine_runs(mesh, dev, world, snap_path)
    out["engine_wall_s"] = time.monotonic() - t0

    if dev.type == "cuda":
        out["checks"] = _tp_kernel_checks(dev, r.config, world, rank, spec.shape.batch,
                                          spec.shape.seq, sspec.shape.prompt_len)
        eng = out["engine"]
        checks = _tp_engine_checks(dev, r.config, world, rank, {
            "prompt": build_spec("serve", sets=list(MESH_TP_ENGINE_SETS)).shape.prompt_len,
            "blocks": (eng["mono"]["blocks"], eng["paged"]["blocks"])})
        for key, err in checks.items():
            out["checks"][key] = max(out["checks"].get(key, 0.0), err)
    if ep:  # 8h, llama3.2-1b's shards and the caching allocator's blocks freed first
        _free(dev)
        out["ep"] = _ep_runs(mesh, dev, world, rank, spec_path)
        for key, err in out["ep"].get("checks", {}).items():
            key = EP_CHECK_KEYS.get(key, key)
            out["checks"][key] = max(out["checks"].get(key, 0.0), err)
    if ssm:  # 8i, 8h's runs freed first
        _free(dev)
        out["ssm"] = _ssm_runs(mesh, dev, world, rank, spec_path)
        for key, err in out["ssm"].get("checks", {}).items():
            key = EP_CHECK_KEYS.get(key, key)
            out["checks"][key] = max(out["checks"].get(key, 0.0), err)
    out["staged_hops"] = mesh.staged_hops
    out["model_hops"] = mesh.hops.get("model", 0)
    out["wall_s"] = time.monotonic() - t_rank
    return out


def _serve_tokens(spec, cfg, dev):
    """The static path's prompts: the ServeSession's synthetic batch."""
    import torch

    from repro_torch.api import threefry
    from repro_torch.api.sessions import synthetic_batch

    arch = spec.resolve().arch
    return torch.as_tensor(synthetic_batch(arch, cfg, spec.shape.batch, spec.shape.prompt_len,
                                           threefry.prng_key(spec.seeds.seed))["tokens"]
                           ).to(dev).to(torch.int64)


def _static_logit_gaps(spec, dev) -> dict:
    """The unsharded static path of ``spec`` step by step (ServeSession's
    prefill, pad_cache and greedy decode): its tokens, the first step's
    logits and each step's top-2 logit gap per row."""
    import torch

    from repro_torch.models.lm import lm_init, pad_cache
    from repro_torch.serving.steps import make_decode_step, make_prefill_step

    r = spec.resolve()
    cfg, gen = r.config, spec.shape.gen
    params = lm_init(cfg, spec.seeds.seed, device=dev)
    prefill, decode = make_prefill_step(cfg, r.spring), make_decode_step(cfg, r.spring)
    with torch.no_grad():
        logits, cache = prefill(params, _serve_tokens(spec, cfg, dev))
        first = logits.cpu()
        top = logits.topk(2, dim=-1).values
        prefill_gap = (top[:, 0] - top[:, 1]).cpu()
        cache, nxt = pad_cache(cache, gen), logits.argmax(-1)
        toks, gaps = [], []
        for _ in range(gen):
            logits, cache = decode(params, nxt, cache)
            top = logits.topk(2, dim=-1).values
            gaps.append((top[:, 0] - top[:, 1]).cpu())
            nxt = logits.argmax(-1)
            toks.append(nxt.cpu())
    del params, cache, logits
    return {"first_logits": first, "tokens": torch.stack(toks, 1).tolist(),
            "gaps": torch.stack(gaps, 1), "prefill_gap": prefill_gap}


def phase_mesh(dev, moe_runs=None) -> dict:
    """(8) the mesh, one process per rank over a gloo group, every rank on
    cuda:0 (the kernels built by the parent; ranks only load them), each
    spawn with a time limit: the unsharded runs first in this process, then
    four ranks (8a collectives at 2**26 elements a rank, 8c llama3.2-1b
    served at data=4, 8d the pipeline) and two ranks (8b llama3.2-1b trained
    at data=2, then at pod=2 with compress_pod_grads).  Sharded losses and
    tokens must equal the unsharded run's bit for bit; every rank's counters
    are zeroed just before each main-path run and read just after.  Then four
    ranks at model = 4: 8e (training), 8f (the static path), 8g (the
    engines, monolithic, paged and pruned, against their unsharded runs here,
    and a model-4 snapshot restored here) and 8h (olmoe-1b-7b and
    deepseek-v2-lite-16b served against 6k's tokens, ``moe_runs``, and
    olmoe-1b-7b trained against its unsharded run here)."""
    import math
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.api import ServeSession, TrainSession, build_spec
    from repro_torch.dist import launch
    from repro_torch.optim.optimizers import tree_leaves

    t_phase = time.monotonic()
    spec_path = str(ROOT / TRAIN_SPEC_FILE)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the unsharded runs, in this process ---------------------------------------------
    t0 = time.monotonic()
    base_train = TrainSession(build_spec("train", spec_file=spec_path,
                                         sets=list(MESH_TRAIN_SETS)), device=dev).run()
    torch.cuda.synchronize()
    base_losses, base_train_s = base_train["losses"], time.monotonic() - t0
    base_sums = _leaf_checksums(tree_leaves(base_train["state"].params), dev).cpu()
    del base_train
    gc.collect()
    torch.cuda.empty_cache()
    base_serve = ServeSession(build_spec("serve", sets=list(MESH_SERVE_SETS)), device=dev).run()
    base_tokens = base_serve["generated"].tolist()
    base_prefill_s, base_tps = base_serve["prefill_s"], base_serve["tokens_per_s"]
    del base_serve
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] unsharded: train losses {base_losses} ({base_train_s:.1f} s); serve prefill "
          f"{base_prefill_s:.3f} s, {base_tps:.1f} tokens/s", flush=True)
    # 8e / 8f's unsharded runs: the example spec with nearest rounding, and the
    # static path step by step (its first logits and each step's top-2 gap)
    t0 = time.monotonic()
    tp_base = TrainSession(build_spec("train", spec_file=spec_path,
                                      sets=list(MESH_TP_TRAIN_SETS)), device=dev).run()
    torch.cuda.synchronize()
    tp_base_losses, tp_base_s = tp_base["losses"], time.monotonic() - t0
    del tp_base
    gc.collect()
    torch.cuda.empty_cache()
    static = _static_logit_gaps(build_spec("serve", sets=list(MESH_SERVE_SETS)), dev)
    gc.collect()
    torch.cuda.empty_cache()
    if static["tokens"] != base_tokens:
        fail("mesh phase: the step-by-step static path's tokens differ from the ServeSession's")
    print(f"[mesh] unsharded, nearest rounding: train losses {tp_base_losses} "
          f"({tp_base_s:.1f} s)", flush=True)

    # -- four ranks: collectives, serving, the pipeline ----------------------------------
    t0 = time.monotonic()
    four = launch.run(mesh_rank_four, MESH_SERVE_DATA, (MESH_SERVE_SETS,),
                      timeout_s=MESH_TIMEOUT_S, collective_timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
    four_s = time.monotonic() - t0
    for rank, r in enumerate(four):
        for row in r["collectives"]:
            print(f"[mesh] rank {rank} {row['dtype']} density {row['density']}: collective = "
                  f"simulation {row['equal']}, mask_pack = plain {row['mask_pack_equal']}, "
                  f"wire {row['wire_bytes'] / 2**20:.1f} MiB ({row['compression_vs_fp32']:.4f}x "
                  f"less than fp32), all-gather {row['ms']:.1f} ms", flush=True)
            if not (row["equal"] and row["mask_pack_equal"] and row.get(
                    "reduce_scatter_equal", True)):
                fail(f"mesh phase: rank {rank}'s collective at density {row['density']} "
                     f"{row['dtype']} disagrees with simulation mode or its plain pack")
        sv = r["serve"]
        print(f"[mesh] rank {rank} ({r['backend']}, {r['staged_hops']} hops staged through the "
              f"host) serve data={MESH_SERVE_DATA}: prefill {sv['prefill_s']:.3f} s, "
              f"{sv['tokens_per_s']:.1f} tokens/s, wall {sv['wall_s']:.1f} s, tokens equal "
              f"{sv['generated'] == base_tokens}, launches {sv['launches']}; pipeline "
              f"{r['pipeline']['ms']:.1f} ms, max_abs_err {r['pipeline']['max_abs_err']:.3g}, "
              f"bit-equal {r['pipeline']['equal']}; peak {r['peak_gib']:.2f} GiB, "
              f"wall {r['wall_s']:.1f} s", flush=True)
        if sv["generated"] != base_tokens or not sv["finite"] or not sv["probe"]["exact"]:
            fail(f"mesh phase: rank {rank}'s sharded tokens differ from the unsharded run's")
        for name in MESH_SERVE_KERNELS:
            if sv["launches"][name] <= 0:
                fail(f"mesh phase: rank {rank}'s sharded serving never launched {name}")
        if not r["pipeline"]["within"] or r["pipeline"]["launches"]["masked_matmul"] <= 0:
            fail(f"mesh phase: rank {rank}'s pipeline disagrees with the stages in sequence")

    # -- two ranks: data=2 training, then the pod link --------------------------------------
    t0 = time.monotonic()
    two = launch.run(mesh_rank_two, MESH_TRAIN_DATA, (spec_path, MESH_TRAIN_SETS),
                     timeout_s=MESH_TIMEOUT_S, collective_timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
    two_s = time.monotonic() - t0
    for rank, r in enumerate(two):
        dt, pod = r["data"], r["pod"]
        print(f"[mesh] rank {rank} ({r['backend']}, {r['staged_hops']} hops staged) train "
              f"data={MESH_TRAIN_DATA}: losses {dt['losses']} (bit-equal "
              f"{dt['losses'] == base_losses}), trained parameters bit-equal "
              f"{torch.equal(dt['sums'], base_sums)}, on grid {dt['grid']}, probe exact "
              f"{dt['probe']['exact']}, wall {dt['wall_s']:.1f} s, peak {dt['peak_gib']:.2f} GiB, "
              f"launches {dt['launches']}", flush=True)
        print(f"[mesh] rank {rank} pod=2 compress_pod_grads: losses {pod['losses']}, ef = local - "
              f"dequant {pod['ef_exact']}, worst |ef| / step {pod['ef_worst_over_step']:.4f}, "
              f"worst |exchanged - true mean| / step {pod['worst_err_over_step']:.4f} (sample), "
              f"parameters bit-equal across pods {pod['params_same']}, on grid {pod['grid']}, wall "
              f"{pod['wall_s']:.1f} s, peak {pod['peak_gib']:.2f} GiB", flush=True)
        if dt["losses"] != base_losses or not torch.equal(dt["sums"], base_sums):
            fail(f"mesh phase: rank {rank}'s data={MESH_TRAIN_DATA} losses or trained "
                 "parameters differ from the unsharded run's")
        if not (dt["grid"] and dt["probe"]["exact"]):
            fail(f"mesh phase: rank {rank}'s sharded parameters left the grid or the probe "
                 "was not exact")
        for name in MESH_TRAIN_KERNELS:
            if dt["launches"][name] <= 0:
                fail(f"mesh phase: rank {rank}'s sharded training never launched {name}")
        if not (all(math.isfinite(v) for v in pod["losses"]) and pod["grid"] and pod["ef_exact"]
                and pod["params_same"] and max(pod["ef_worst_over_step"], pod["worst_err_over_step"]) <= 1.0 + 1e-5):
            fail(f"mesh phase: rank {rank}'s compressed pod link broke its contract")
    # -- four ranks at model = 4: tensor parallelism, trained and served -------------------
    t0 = time.monotonic()
    engine_base = _tp_engine_base(dev)
    engine_base_s = time.monotonic() - t0
    ep_base = _ep_base(dev, spec_path, moe_runs)
    _free(dev)
    ssm_base = _ssm_base(dev, spec_path)
    _free(dev)
    snap_dir = tempfile.mkdtemp(prefix="chip_smoke_8g_")
    snap_path = os.path.join(snap_dir, "tp_snapshot.npz")
    try:
        t0 = time.monotonic()
        tp = launch.run(mesh_rank_tp, MESH_TP, (spec_path, MESH_TP_TRAIN_SETS,
                                                MESH_SERVE_SETS, snap_path, True, True),
                        timeout_s=MESH_TIMEOUT_S,
                        collective_timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
        tp_s = time.monotonic() - t0
        restored = _tp_engine_restore(dev, snap_path)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    tp_gate = _tp_gates(tp, tp_base_losses, base_tokens, static)
    tp_gate["engine"] = _tp_engine_gates(tp, engine_base, restored, tp_gate["max_logit_diff"])
    tp_gate["ep"] = _ep_gates(tp, ep_base)
    tp_gate["ssm"] = _ssm_gates(tp, ssm_base)
    print(f"[mesh] 8g unsharded runs {engine_base_s:.1f} s; each rank's engine runs "
          f"{max(r['engine_wall_s'] for r in tp):.1f} s; 8h unsharded runs "
          f"{ep_base['wall_s']:.1f} s, each rank's 8h runs "
          f"{max(r['ep']['runs_s'] for r in tp):.1f} s and checks "
          f"{max(r['ep'].get('checks_s', 0.0) for r in tp):.1f} s; 8i unsharded runs "
          f"{ssm_base['wall_s']:.1f} s, each rank's 8i runs "
          f"{max(r['ssm']['runs_s'] for r in tp):.1f} s and checks "
          f"{max(r['ssm'].get('checks_s', 0.0) for r in tp):.1f} s", flush=True)
    wall = time.monotonic() - t_phase
    print(f"[mesh] four ranks {four_s:.1f} s, two ranks {two_s:.1f} s, model=4 ranks "
          f"{tp_s:.1f} s, phase {wall:.1f} s", flush=True)
    # every rank's main-path launches: the serve, pipeline, data=2 and pod=2 runs;
    # the model=4 runs apart (the kernel line's mesh_tp path)
    launches = {name: sum(r["serve"]["launches"][name] + r["pipeline"]["launches"][name]
                          for r in four)
                + sum(r["data"]["launches"][name] + r["pod"]["launches"][name] for r in two)
                for name in four[0]["serve"]["launches"]}
    tp_launches = {name: sum(r["train"]["launches"][name] + r["serve"]["launches"][name]
                             + sum(r["engine"][run]["launches"][name]
                                   for run in MESH_TP_ENGINE_RUNS)
                             + _ep_launches(r, name) + _ssm_launches(r, name)
                             for r in tp) for name in launches}
    for r in tp:
        r.pop("first_logits", None)
        _ep_strip(r)
        _ssm_strip(r)
    for r in two:
        r["data"].pop("sums")
    for r in engine_base.values():
        r.pop("gaps", None)
    return {"four": four, "two": two, "tp": tp, "tp_gate": tp_gate,
            "base_losses": base_losses, "base_tokens": base_tokens,
            "tp_base_losses": tp_base_losses, "base_prefill_s": base_prefill_s,
            "base_tokens_per_s": base_tps, "launches": launches, "tp_launches": tp_launches,
            "wall_s": wall, "tp_wall_s": tp_s, "engine_base": engine_base,
            "ep_base": {**{arch: {k: v for k, v in ep_base[arch].items() if k not in EP_RECORD}
                           for arch in MOE_ARCHS}, "wall_s": ep_base["wall_s"]},
            "ssm_base": {"serve": {arch: {k: v for k, v in run.items() if k not in EP_RECORD}
                                   for arch, run in ssm_base["serve"].items()},
                         "train": ssm_base["train"], "wall_s": ssm_base["wall_s"]},
            "errs": {"masked_matmul": max(r["pipeline"]["max_abs_err"] for r in four),
                     "tp": {k: max(r["checks"][k] for r in tp) for k in tp[0]["checks"]}}}


def _tp_engine_base(dev) -> dict:
    """8g's unsharded runs in this process, each recording its top-2 gaps:
    the monolithic and paged engines and the pruned monolithic one, on the
    same prompts and weights as the ranks'."""
    from repro_torch.api import build_spec
    from repro_torch.models.lm import lm_init

    spec = build_spec("serve", sets=list(MESH_TP_ENGINE_SETS))
    cfg = spec.resolve().config
    prompts, shared = _tp_engine_prompts(spec, cfg.vocab)
    params = lm_init(cfg, spec.seeds.seed, device=dev)
    out = {"mono": _tp_engine_run("mono", spec, params, prompts, dev, gaps=True),
           "paged": _tp_engine_run("paged", build_spec("serve", sets=[
               *MESH_TP_ENGINE_SETS, "serving.pages=true"]), params, shared, dev, gaps=True),
           "pruned": _tp_engine_run("pruned", spec, params, prompts, dev, prune=MESH_TP_PRUNE,
                                    gaps=True)}
    del params
    _free(dev)
    for name, r in out.items():
        print(f"[mesh] 8g unsharded {name}: prefill {r['prefill_s']:.3f} s, "
              f"{r['tokens_per_s']:.1f} tokens/s, {r['ticks']} ticks, peak "
              f"{r['peak_gib']:.2f} GiB, wall {r['wall_s']:.1f} s", flush=True)
    return out


def _tp_engine_restore(dev, snap_path: str) -> list:
    """The model-4 ranks' 8g snapshot restored into an unsharded engine of
    the same spec in this process, run to its end: its tokens."""
    from repro_torch.api import build_spec
    from repro_torch.models.lm import lm_init
    from repro_torch.serving.engine import ServingEngine

    spec = build_spec("serve", sets=list(MESH_TP_ENGINE_SETS))
    eng = ServingEngine.from_spec(spec, params=lm_init(spec.resolve().config, spec.seeds.seed,
                                                       device=dev), device=dev)
    eng.restore_file(snap_path)
    tokens = [r["tokens"] for r in eng.run()["per_request"]]
    del eng
    _free(dev)
    return tokens


def _tie_gate(tag: str, got: list, want: list, gaps: list, logit_diff: float) -> dict:
    """8f's rule for a printed near tie, on an engine's per-request tokens:
    equal, or first differing where the unsharded top-2 gap behind that
    token is below 8f's measured first-step max logit difference, itself
    within MESH_TP_LOGIT_ATOL."""
    if got == want:
        return {"equal": True}
    diffs = [(rid, i) for rid in range(len(want)) for i in range(len(want[rid]))
             if i >= len(got[rid]) or got[rid][i] != want[rid][i]]
    rid, i = min(diffs, key=lambda d: (d[1], d[0]))
    gap = gaps[rid][i]
    print(f"[mesh] 8g {tag} near tie: request {rid} first differs at token {i}, unsharded "
          f"top-2 gap {gap:.3g} against 8f's first-step max |logit diff| {logit_diff:.3g}",
          flush=True)
    if not (gap < logit_diff <= MESH_TP_LOGIT_ATOL):
        fail(f"mesh phase: 8g {tag} tokens differ from the unsharded run's at request {rid} "
             f"token {i}, where the top-2 gap {gap:.3g} is no near tie (8f's first-step max "
             f"|logit diff| {logit_diff:.3g}, atol {MESH_TP_LOGIT_ATOL})")
    return {"equal": False, "near_tie": {"request": rid, "token": i, "gap": gap}}


def _tp_engine_gates(tp: list, base: dict, restored: list, logit_diff: float) -> dict:
    """8g's gates over the model=4 ranks: tokens finite and equal across
    ranks, and to the unsharded run's under 8f's near-tie rule; each rank's
    pool its kv heads' share (2 of 8 heads: a quarter of the values and
    mask words, every block's nnz); the wire figures the unsharded pool's;
    every path kernel launched on every rank; the snapshot taken at model 4
    restored unsharded with the ranks' tokens."""
    out: dict = {}
    for rank, r in enumerate(tp):
        eng = r["engine"]
        for name in MESH_TP_ENGINE_RUNS:
            e = eng[name]
            hops = e["model_hops"] / max(e["ticks"], 1)
            print(f"[mesh] rank {rank} 8g {name} engine model={MESH_TP}: prefill "
                  f"{e['prefill_s']:.3f} s ({e['prefill_s'] / len(e['tokens']):.3f} a request), "
                  f"decode {e['decode_s']:.3f} s, {e['tokens_per_s']:.1f} tokens/s (unsharded "
                  f"{base[name]['tokens_per_s']:.1f}), {e['ticks']} ticks, {hops:.1f} model hops "
                  f"a tick, peak {e['peak_gib']:.2f} GiB, wall {e['wall_s']:.1f} s, launches "
                  f"{e['launches']}", flush=True)
            if e["tokens"] != tp[0]["engine"][name]["tokens"] or not e["finite"]:
                fail(f"mesh phase: rank {rank}'s 8g {name} tokens are not finite or differ "
                     "from rank 0's")
            for kname in MESH_TP_ENGINE_KERNELS:
                if e["launches"][kname] <= 0:
                    fail(f"mesh phase: rank {rank}'s 8g {name} run never launched {kname}")
        for name in ("mono", "paged"):
            mine, whole = eng[name]["pool"], base[name]["pool"]
            print(f"[mesh] rank {rank} 8g {name} pool: kv heads {eng[name]['kv_heads']}, "
                  f"{mine} bytes against the unsharded {whole}; wire {eng[name]['wire']}",
                  flush=True)
            if not (eng[name]["kv_heads"] == [2 * rank, 2 * rank + 1]
                    and mine["values"] * MESH_TP == whole["values"]
                    and mine["mask"] * MESH_TP == whole["mask"]
                    and mine["nnz"] == whole["nnz"]):
                fail(f"mesh phase: rank {rank}'s 8g {name} pool is not its kv heads' share")
            if eng[name]["wire"] != base[name]["wire"]:
                print(f"[mesh] rank {rank} 8g {name}: wire figures {eng[name]['wire']} against "
                      f"the unsharded {base[name]['wire']}", flush=True)
    for name in MESH_TP_ENGINE_RUNS:
        out[name] = _tie_gate(name, tp[0]["engine"][name]["tokens"], base[name]["tokens"],
                              base[name]["gaps"], logit_diff)
    out["snapshot"] = _tie_gate("snapshot restored unsharded", restored,
                                tp[0]["engine"]["mono"]["tokens"], base["mono"]["gaps"],
                                logit_diff)
    print(f"[mesh] 8g: the model-4 snapshot at tick {MESH_TP_SNAPSHOT_TICK} restored unsharded "
          f"gives the ranks' remaining tokens {out['snapshot']['equal']}", flush=True)
    return out


def _tp_gates(tp: list, base_losses: list, base_tokens: list, static: dict) -> dict:
    """8e / 8f's gates over the model=4 ranks: losses finite, on the grid,
    bit-equal across ranks and within rel MESH_TP_LOSS_RTOL of the
    unsharded run's; tokens equal across ranks and to the unsharded run's,
    but where the first differing step's unsharded top-2 gap is below the
    first step's measured max logit difference (a near tie, printed; the
    first step's logits then held at atol MESH_TP_LOGIT_ATOL); every path
    kernel launched on every rank; each rank's shards alone its parameter
    bytes, and its peak below half the unsharded run's."""
    import math

    out: dict = {}
    losses = tp[0]["train"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
    logit_diff = max(float((r["first_logits"] - static["first_logits"]).abs().max()) for r in tp)
    out.update(loss_rel=rel, max_logit_diff=logit_diff)
    for rank, r in enumerate(tp):
        t, sv = r["train"], r["serve"]
        rep = t["report"]
        print(f"[mesh] rank {rank} ({r['backend']}) 8e train model={MESH_TP}: losses "
              f"{t['losses']} (unsharded {base_losses}, max rel {rel:.3g}), on grid {t['grid']}, "
              f"session wall {t['wall_s']:.1f} s, one step alone {t['step_s']:.3f} s "
              f"({t['tokens_per_s']:.1f} tokens/s, {t['step_model_hops']} model hops, "
              f"{t['step_staged_hops']} staged), param bytes {rep['param_bytes']} (shards "
              f"{t['param_bytes_want']}), {rep['model_hops']} model hops / {rep['staged_hops']} "
              f"staged in the session, peak {t['peak_gib']:.2f} GiB, launches {t['launches']}",
              flush=True)
        print(f"[mesh] rank {rank} 8f static serve model={MESH_TP}: prefill "
              f"{sv['prefill_s']:.3f} s, decode {sv['decode_s']:.3f} s, "
              f"{sv['tokens_per_s']:.1f} tokens/s, tokens equal the unsharded run's "
              f"{sv['generated'] == base_tokens}, first-step max |logit diff| "
              f"{float((r['first_logits'] - static['first_logits']).abs().max()):.3g}, "
              f"{sv['model_hops']} model hops / {sv['staged_hops']} staged, "
              f"peak {sv['peak_gib']:.2f} GiB, launches {sv['launches']}; kernels at the shard "
              f"shapes {r.get('checks')}; rank wall {r['wall_s']:.1f} s", flush=True)
        if t["losses"] != losses or not all(math.isfinite(v) for v in t["losses"]):
            fail(f"mesh phase: rank {rank}'s model={MESH_TP} losses are not finite or differ "
                 "from rank 0's")
        if not t["grid"]:
            fail(f"mesh phase: rank {rank}'s model={MESH_TP} shards left the grid")
        if rep["param_bytes"] != t["param_bytes_want"]:
            fail(f"mesh phase: rank {rank} holds {rep['param_bytes']} parameter bytes, not its "
                 f"shards' {t['param_bytes_want']}")
        for peak in (t["peak_gib"], sv["peak_gib"]):
            if not peak < MESH_UNSHARDED_PEAK_GIB / 2:
                fail(f"mesh phase: rank {rank}'s model={MESH_TP} peak {peak:.2f} GiB is not "
                     f"below half the unsharded {MESH_UNSHARDED_PEAK_GIB} GiB")
        for name in MESH_TP_TRAIN_KERNELS:
            if t["launches"][name] <= 0:
                fail(f"mesh phase: rank {rank}'s model={MESH_TP} training never launched {name}")
        for name in MESH_TP_SERVE_KERNELS:
            if sv["launches"][name] <= 0:
                fail(f"mesh phase: rank {rank}'s model={MESH_TP} serving never launched {name}")
        if sv["generated"] != tp[0]["serve"]["generated"] or not sv["finite"]:
            fail(f"mesh phase: rank {rank}'s model={MESH_TP} tokens differ from rank 0's")
    if not rel <= MESH_TP_LOSS_RTOL:
        fail(f"mesh phase: model={MESH_TP} losses {losses} off the unsharded {base_losses} "
             f"by rel {rel:.3g}")
    got = tp[0]["serve"]["generated"]
    out["tokens_equal"] = got == base_tokens
    if got != base_tokens:
        diffs = [(i, b) for b in range(len(got)) for i in range(len(got[b]))
                 if got[b][i] != base_tokens[b][i]]
        i, b = min(diffs)
        gap = float(static["gaps"][b, i])
        if i == 0:
            gap = min(gap, float(static["prefill_gap"][b]))
        print(f"[mesh] 8f near tie: row {b} first differs at step {i}, unsharded top-2 gap "
              f"{gap:.3g} against the first step's max |logit diff| {logit_diff:.3g}", flush=True)
        out["near_tie"] = {"row": b, "step": i, "gap": gap}
        if not (gap < logit_diff and logit_diff <= MESH_TP_LOGIT_ATOL):
            fail(f"mesh phase: model={MESH_TP} tokens differ from the unsharded run's at row "
                 f"{b} step {i}, where the top-2 gap {gap:.3g} is no near tie (first-step max "
                 f"|logit diff| {logit_diff:.3g}, atol {MESH_TP_LOGIT_ATOL})")
    return out


# -- 8h. expert parallelism: the MoE family at model = 4 ------------------------------------


@contextlib.contextmanager
def _moe_routing(rec: dict, k: int):
    """Inside the block, file every MoE call's routing under the engine
    step running (``rec["at"]``, :func:`_engine_gaps`), a list in layer
    order of (each row's ``k`` experts, sorted; its gap between the k-th
    and (k+1)-th router probability), on the device until the run ends
    (:func:`_ep_record`).  The routing is recomputed beside ``moe_apply``'s
    by the same function on the same rows (``moe._route``, in fixed row
    blocks at decode), so it is the bits the call routes by (8h's near-tie
    rule).  A prefill's rows are its request's positions; a decode tick's
    are the slots."""
    import torch

    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import fixed_rows

    apply = moe_mod.moe_apply

    def recorded(params, x, ctx, spec):
        with torch.no_grad():
            flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
            router, e = params["router"]["kernel"], spec.n_experts
            routed = (fixed_rows(lambda r: moe_mod._route(r, router, k), flat)
                      if x.shape[1] == 1 else moe_mod._route(flat, router, k))
            top = routed[:, :e].topk(k + 1, dim=-1).values
            experts = routed[:, e + k:].to(torch.int16).sort(dim=-1).values
            rec["routing"].setdefault(rec["at"], []).append((experts, top[:, k - 1] - top[:, k]))
        return apply(params, x, ctx, spec)

    moe_mod.moe_apply = recorded
    try:
        yield
    finally:
        moe_mod.moe_apply = apply


def _ep_record(eng, out: dict, rec: dict) -> dict:
    """An engine run's records for 8h's near-tie rule, on the CPU: each
    token's top-2 logit gap (:func:`_token_gaps`), each request's first
    token tick and slot, its prefill logits and the routing by step
    (:func:`_moe_routing`)."""
    return {"gaps": _token_gaps(eng, out, rec),
            "first_tick": [r["first_token_tick"] for r in out["per_request"]],
            "slots": [eng._results[r["rid"]].slot for r in out["per_request"]],
            "first_logits": rec["first_logits"],
            "routing": {at: [(e.cpu(), g.cpu()) for e, g in layers]
                        for at, layers in rec["routing"].items()}}


#: the keys of :func:`_ep_record`, dropped from the report
EP_RECORD = ("gaps", "first_tick", "slots", "first_logits", "routing")


def _ep_config(arch: str, units: int):
    from repro_torch.configs import get_arch

    full = get_arch(arch).resolve(False)
    return full if units == full.n_units else _cut(full, units)


def _ep_serve(dev, arch: str, units: int, mesh=None, traffic: tuple = MOE_TRAFFIC) -> dict:
    """One of 8h's (and 8i's) serving runs: ``arch`` at ``units`` units,
    quant_sparse, random weights from seed 0 (the rank's shards drawn leaf
    by leaf under ``mesh``), ``traffic`` (requests, prompt, gen, max_len:
    6k's, MOE_REQUESTS requests of prompt MOE_PROMPT, MOE_GEN tokens each,
    on as many slots) through the monolithic engine, the counters zeroed
    just before ``run()`` and read just after.  Records what 8h's near-tie
    rule reads (:func:`_ep_record`; an MoE arch's routing too); under
    ``mesh`` every rank meets the others at its peak and reads the card's
    free memory there, and counts the bytes its shards and its part of the
    pool must take."""
    import torch

    from repro_torch import kernels
    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import kvpool
    from repro_torch.serving.engine import ServingEngine

    requests, prompt, gen, max_len = traffic
    cfg = _ep_config(arch, units)
    _free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    params = lm_init(cfg, 0, device=dev, mesh=mesh)
    _sync(dev)
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _tensors(params))
    prompts = synthetic_prompts(requests, requests, prompt, cfg.vocab, 0)
    eng = ServingEngine(cfg, serving_config("quant_sparse"), params=params,
                        n_slots=requests, max_len=max_len, device=dev, mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, gen, seed=i)
    rec = _engine_gaps(eng, first_logits=True)
    hops = mesh.hops.get("model", 0) if mesh is not None else 0
    _sync(dev)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    with (_moe_routing(rec, cfg.moe.top_k) if cfg.moe is not None
          else contextlib.nullcontext()):
        out = eng.run()
    _sync(dev)
    wall, launches = time.monotonic() - t0, kernels.launch_counts()
    res = {"tokens": [r["tokens"] for r in out["per_request"]], "ticks": out["ticks"],
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "tokens_per_s": out["tokens_per_s"], "finite": out["finite"], "wall_s": wall,
           "launches": launches, "init_s": init_s, "params": n_params,
           "param_bytes": 4 * n_params, **_ep_record(eng, out, rec), "n_layers": cfg.n_layers,
           "kv_heads": None if eng.heads is None else list(eng.heads.mine),
           "pool_bytes": eng.pool_bytes(), "state_bytes": eng.state_bytes(),
           "peak_gib": _peak_gib(dev)}
    if mesh is not None:
        res["model_hops"] = mesh.hops.get("model", 0) - hops
        res["param_bytes_want"] = _shard_bytes(cfg, mesh)
        res["pool_bytes_want"] = _pool_bytes_want(eng)
        res["pool_sum"] = _leaf_checksums(kvpool.pool_leaves(eng.pool), dev).cpu()
        mesh.all_gather(torch.zeros(1, device=dev), "model")  # every rank at its peak
        res["free_gib"] = (torch.cuda.mem_get_info(dev)[0] / 2**30 if dev.type == "cuda"
                           else float("inf"))
    del eng, out, params
    _free(dev)
    return res


def _ep_train(dev, spec, mesh=None, units: int = MESH_EP_TRAIN_UNITS) -> dict:
    """8h's (and 8i's) training: ``spec`` (the example train spec on
    olmoe-1b-7b, nearest rounding) at ``units`` of its units through
    make_train_step, from seed 0 (the rank's shards drawn leaf by leaf
    under ``mesh``), each step timed to its synchronise, the counters
    zeroed just before the first and read just after the last.  Under
    ``mesh``: the checksums of the leaves every rank holds whole, and the
    bytes its shards must take."""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import on_grid
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.train import init_train_state, make_train_step
    from repro_torch.runtime.tree_sharding import leaf_splits, param_splits

    r = spec.resolve()
    cfg, seed = _cut(r.config, units), spec.seeds.seed
    _free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(lm_init(cfg, seed, device=dev, mesh=mesh), r.step, seed,
                             device=dev)
    step = make_train_step(get_arch(spec.arch.id).view(config=cfg), r.step, mesh=mesh)
    data = SyntheticLMStream(DataConfig(seed=seed, vocab=cfg.vocab, seq_len=spec.shape.seq,
                                        global_batch=spec.shape.batch), device=dev)
    hops = mesh.hops.get("model", 0) if mesh is not None else 0
    losses, steps_s = [], []
    _sync(dev)
    kernels.reset_launch_counts()
    for i in range(spec.train.steps):
        t0 = time.monotonic()
        state, m = step(state, {"tokens": data.batch(i)})
        _sync(dev)
        steps_s.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
    launches = kernels.launch_counts()
    leaves = tree_leaves(state.params)
    res = {"losses": losses, "steps_s": steps_s, "launches": launches,
           "n_layers": cfg.n_layers, "grid": on_grid(dict(enumerate(leaves))),
           "param_bytes": sum(4 * p.numel() for p in leaves), "peak_gib": _peak_gib(dev),
           "tokens_per_s": spec.shape.batch * spec.shape.seq / steps_s[-1]}
    if mesh is not None:
        world = int(mesh.shape["model"])
        with sharding_context(mesh):
            splits = leaf_splits(param_splits(cfg, mesh), state.params)
        res["model_hops"] = mesh.hops.get("model", 0) - hops
        res["param_bytes_want"] = sum(4 * (math.prod(s.full) // world if s is not None
                                           else p.numel()) for p, s in zip(leaves, splits))
        res["replicated"] = _leaf_checksums([p for p, s in zip(leaves, splits) if s is None],
                                            dev).cpu()
        res["whole_leaves"] = sum(1 for s in splits if s is None)
    del state, step, m
    _free(dev)
    return res


def _ep_kernel_checks(dev, rank: int, world: int, spec) -> dict:
    """8h's path kernels on this rank at the shard shapes its runs gave
    them, against their plain versions: 6k's serving checks
    (:func:`_moe_kernel_checks`: the expert products at decode and at the
    prefill's capacity, whole experts, the rank's heads' projections, its
    dense and shared SwiGLU columns, flash_attention on olmoe's 4 local
    heads, kv_pack on the rank's pool leaves) and 5g's training checks
    (:func:`_train_arch_kernel_checks`: forward, dx and dw of olmoe's
    products at the rank's shapes, stochastic_round on its vocabulary
    rows), and the strided stochastic_round on a dim-0 expert shard
    bit-equal."""
    import torch

    from repro_torch.kernels.stochastic_round.ops import (shard_counter, sr_reference,
                                                          stochastic_round)

    def local(cfg):
        import dataclasses as dc

        kw = {"vocab": cfg.vocab // world, "d_ff": cfg.d_ff // world,
              "moe": dc.replace(cfg.moe, shared_d_ff=cfg.moe.shared_d_ff // world)}
        if cfg.attn is not None:
            kw["attn"] = dc.replace(cfg.attn, n_heads=cfg.attn.n_heads // world,
                                    n_kv_heads=cfg.attn.n_kv_heads // world)
        if cfg.mla is not None:
            kw["mla"] = dc.replace(cfg.mla, n_heads=cfg.mla.n_heads // world)
        return dc.replace(cfg, **kw)

    errs: dict = {}
    for i, arch in enumerate(MOE_ARCHS):
        got = _moe_kernel_checks(dev, local(_ep_config(arch, MESH_EP_UNITS[arch])),
                                 seed=80 + 8 * rank + i)["errs"]
        for k, v in got.items():
            errs[k] = max(errs.get(k, 0.0), v)
    cfg = local(_cut(spec.resolve().config, MESH_EP_TRAIN_UNITS))
    got = _train_arch_kernel_checks(dev, "olmoe-1b-7b", cfg,
                                    spec.shape.batch * spec.shape.seq)["errs"]
    for k, v in got.items():
        errs[k] = max(errs.get(k, 0.0), v)
    moe = cfg.moe
    per = moe.n_experts // world
    g = torch.Generator(device=dev).manual_seed(90 + rank)
    w = torch.randn(4, cfg.d_model, moe.d_ff, generator=g, device=dev)
    base, stride = shard_counter((moe.n_experts, cfg.d_model, moe.d_ff), 0, rank * per)
    if not torch.equal(stochastic_round(w, 11, base=base, row_stride=stride),
                       sr_reference(w, 11, base=base, row_stride=stride)):
        fail(f"mesh_ep rank {rank}: the strided stochastic_round on its expert shard "
             f"{tuple(w.shape)} differs from its plain version")
    del w
    _free(dev)
    print(f"[mesh_ep rank {rank}] 8h kernels at the shard shapes: {errs}; stochastic_round on "
          f"experts [{rank * per}, {rank * per + 4}) bit-equal", flush=True)
    return errs


def _ep_runs(mesh, dev, world: int, rank: int, spec_path: str) -> dict:
    """8h on one rank at model = ``world``: olmoe-1b-7b and
    deepseek-v2-lite-16b served (MESH_EP_UNITS), olmoe-1b-7b trained, then
    (on the card) the path kernels at the shard shapes."""
    from repro_torch.api import build_spec

    t0 = time.monotonic()
    out = {arch: _ep_serve(dev, arch, MESH_EP_UNITS[arch], mesh) for arch in MOE_ARCHS}
    spec = build_spec("train", spec_file=spec_path, sets=[*MESH_EP_TRAIN_SETS,
                                                          f"shape.mesh.model={world}"])
    out["train"] = _ep_train(dev, spec, mesh)
    out["runs_s"] = time.monotonic() - t0
    if dev.type == "cuda":
        t0 = time.monotonic()
        out["checks"] = _ep_kernel_checks(dev, rank, world, spec)
        out["checks_s"] = time.monotonic() - t0
    return out


def _ep_base(dev, spec_path: str, moe_runs) -> dict:
    """8h's unsharded runs in this process: each arch's served tokens and
    records (:func:`_ep_record`; 6k's monolithic run where 6k served the
    same depth, ``moe_runs``; else the same run here) and olmoe's training
    at MESH_EP_TRAIN_UNITS units."""
    from repro_torch.api import build_spec

    t0 = time.monotonic()
    out: dict = {}
    for arch in MOE_ARCHS:
        if moe_runs and arch in moe_runs and MESH_EP_UNITS[arch] == _full_units(arch):
            out[arch] = {**moe_runs[arch], "from": "6k"}
        else:
            run = _ep_serve(dev, arch, MESH_EP_UNITS[arch])
            out[arch] = {"tokens": run["tokens"], "from": "this phase",
                         "tokens_per_s": run["tokens_per_s"], "peak_gib": run["peak_gib"],
                         **{k: run[k] for k in EP_RECORD}}
    out["train"] = _ep_train(dev, build_spec("train", spec_file=spec_path,
                                             sets=list(MESH_EP_TRAIN_SETS)))
    out["wall_s"] = time.monotonic() - t0
    t = out["train"]
    print(f"[mesh] 8h unsharded: served tokens from {[out[a]['from'] for a in MOE_ARCHS]}; "
          f"olmoe-1b-7b trained at {t['n_layers']} layers: losses {t['losses']}, "
          f"{[round(s, 3) for s in t['steps_s']]} s a step, peak {t['peak_gib']:.2f} GiB; "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def _full_units(arch: str) -> int:
    from repro_torch.configs import get_arch

    return get_arch(arch).resolve(False).n_units


def _first_logit_diff(run: dict, base: dict) -> float:
    """The largest |logit difference| of an arch's first step, its
    requests' prefill logits, between the sharded and unsharded runs."""
    return max(float((run["first_logits"][rid] - base["first_logits"][rid]).abs().max())
               for rid in base["first_logits"])


def _routed_otherwise(run: dict, base: dict) -> dict:
    """Where a served ``run`` routes rows to other experts than its
    unsharded ``base`` (printed, not gated: past a step's first such layer
    a row's input has moved with the rows it attends to): the rows so
    routed over every step and layer, the steps holding any, and the
    largest unsharded router gap among the rows of each such step's first
    layer."""
    rows, steps, gap = 0, 0, 0.0
    for at, layers in run["routing"].items():
        first = True
        for (e, _), (be, bg) in zip(layers, base["routing"][at]):
            moved = (e != be).any(-1)
            if bool(moved.any()):
                rows += int(moved.sum())
                if first:
                    steps, first = steps + 1, False
                    gap = max(gap, float(bg[moved].max()))
    return {"rows": rows, "steps": steps, "first_layer_max_gap": gap}


def _ep_tie_gate(tag: str, run: dict, base: dict) -> dict:
    """8h's rule for a printed near tie, on one arch's served ``run``
    against its unsharded ``base``: tokens equal, or at the first step
    where they differ (the request's prefill and first decode tick for its
    first token, else its decode tick) either

    * the first layer at which that step routes any of the request's rows
      (a prefill's positions, or its slot) to other experts than the
      unsharded run does, every such row's unsharded k-th and (k+1)-th
      router probabilities within MESH_EP_ROUTER_TIE; or,
    * where no row of it is routed otherwise, the unsharded top-2 logit
      gap behind the token below this arch's own first-step max |logit
      difference| (:func:`_first_logit_diff`), itself within
      MESH_TP_LOGIT_ATOL (8f's rule: the whole rule for 8i's archs, which
      route nothing).

    A row routed otherwise off a near tie fails, whatever the logits."""
    got, want = run["tokens"], base["tokens"]
    logit_diff = _first_logit_diff(run, base)
    summary = _routed_otherwise(run, base)
    if got == want:
        return {"equal": True, "first_logit_diff": logit_diff, "routed_otherwise": summary}
    tick, rid, i = min((run["first_tick"][rid] + i, rid, i) for rid in range(len(want))
                       for i in range(len(want[rid]))
                       if i >= len(got[rid]) or got[rid][i] != want[rid][i])
    slot = run["slots"][rid]
    flip = None
    for at in ([("prefill", rid)] if i == 0 else []) + [("decode", tick)]:
        rows = slice(None) if at[0] == "prefill" else slice(slot, slot + 1)
        for layer, ((e, _), (be, bg)) in enumerate(zip(run["routing"].get(at, []),
                                                       base["routing"].get(at, []))):
            moved = (e[rows] != be[rows]).any(-1)
            if bool(moved.any()):
                flip = {"step": list(at), "layer": layer, "rows": int(moved.sum()),
                        "router_gap": float(bg[rows][moved].max())}
                break
        if flip:
            break
    gap = base["gaps"][rid][i]
    print(f"[mesh] {tag} near tie: request {rid} first differs at token {i} (tick {tick}), "
          f"unsharded top-2 logit gap {gap:.3g} against the first step's max |logit diff| "
          f"{logit_diff:.3g}; routed otherwise there: {flip}", flush=True)
    if flip is not None:
        if not flip["router_gap"] < MESH_EP_ROUTER_TIE:
            fail(f"mesh phase: {tag} routes {flip['rows']} row(s) of request {rid} to other "
                 f"experts than the unsharded run at {flip['step']} layer {flip['layer']}, "
                 f"where the router's k / k+1 gap {flip['router_gap']:.3g} is no near tie")
    elif not gap < logit_diff <= MESH_TP_LOGIT_ATOL:
        fail(f"mesh phase: {tag} tokens differ from the unsharded run's at request {rid} "
             f"token {i}, where the top-2 gap {gap:.3g} is no near tie (first-step max |logit "
             f"diff| {logit_diff:.3g}, atol {MESH_TP_LOGIT_ATOL})")
    return {"equal": False, "first_logit_diff": logit_diff, "routed_otherwise": summary,
            "near_tie": {"request": rid, "token": i, "gap": gap, "routed_otherwise": flip}}


def _ep_gates(ranks: list, base: dict) -> dict:
    """8h's gates over the model=4 ranks: each served arch's tokens finite,
    equal across ranks and to the unsharded tokens but for a printed near
    tie (:func:`_ep_tie_gate`); olmoe's pool the rank's 4 of 16 kv heads, deepseek's latent pool
    whole and the same bits on every rank; >= MESH_EP_HEADROOM of the card
    free at the ranks' peak; the training losses finite, bit-equal across
    ranks and within rel MESH_TP_LOSS_RTOL of the unsharded run's, the
    parameters on the grid, every leaf held whole the same bits on every
    rank, each rank's parameter bytes its shards'; every path kernel
    launched on every rank."""
    import math

    out: dict = {}
    for arch in MOE_ARCHS:
        runs = [r["ep"][arch] for r in ranks]
        for rank, e in enumerate(runs):
            hops = e["model_hops"] / max(e["ticks"], 1)
            print(f"[mesh] rank {rank} 8h {arch} ({e['n_layers']} layers, "
                  f"{e['params'] / 1e9:.3f} B parameters a rank, drawn in {e['init_s']:.1f} s) "
                  f"served at model={MESH_TP}: prefill {e['prefill_s'] / MOE_REQUESTS:.3f} s a "
                  f"request, decode {e['decode_s']:.3f} s, {e['tokens_per_s']:.2f} tokens/s, "
                  f"{e['ticks']} ticks, {hops:.1f} model hops a tick, kv heads {e['kv_heads']}, "
                  f"pool {e['pool_bytes']} bytes, peak {e['peak_gib']:.2f} GiB, card free "
                  f"{e['free_gib']:.2f} GiB, wall {e['wall_s']:.1f} s, launches {e['launches']}",
                  flush=True)
            if e["tokens"] != runs[0]["tokens"] or not e["finite"]:
                fail(f"mesh phase: rank {rank}'s 8h {arch} tokens are not finite or differ "
                     "from rank 0's")
            for name in MESH_EP_SERVE_KERNELS[arch]:
                if e["launches"][name] <= 0:
                    fail(f"mesh phase: rank {rank}'s 8h {arch} run never launched {name}")
            if arch.startswith("deepseek") and e["launches"]["flash_attention"]:
                fail(f"mesh phase: rank {rank}'s 8h {arch} run launched flash_attention")
            if e["free_gib"] < MESH_EP_HEADROOM / 2**30:
                fail(f"mesh phase: 8h {arch} left {e['free_gib']:.2f} GiB of the card free at "
                     f"the ranks' peak, under {MESH_EP_HEADROOM / 2**30:.0f} GiB")
            if arch.startswith("olmoe"):
                heads = _ep_config(arch, MESH_EP_UNITS[arch]).attn.n_kv_heads // MESH_TP
                if e["kv_heads"] != list(range(rank * heads, (rank + 1) * heads)):
                    fail(f"mesh phase: rank {rank}'s 8h {arch} pool holds kv heads "
                         f"{e['kv_heads']}")
            elif e["kv_heads"] is not None or not bool((e["pool_sum"]
                                                        == runs[0]["pool_sum"]).all()):
                fail(f"mesh phase: rank {rank}'s 8h {arch} latent pool is not whole or not "
                     "rank 0's bits")
        out[arch] = _ep_tie_gate(f"8h {arch}", runs[0], base[arch])
        print(f"[mesh] 8h {arch}: tokens equal to the unsharded run's {out[arch]['equal']}, "
              f"first-step max |logit diff| {out[arch]['first_logit_diff']:.3g}, rows routed "
              f"to other experts than unsharded {out[arch]['routed_otherwise']}", flush=True)
        out[arch]["tokens_from"] = base[arch]["from"]
    losses = ranks[0]["ep"]["train"]["losses"]
    want = base["train"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    out["train"] = {"loss_rel": rel}
    for rank, r in enumerate(ranks):
        t = r["ep"]["train"]
        print(f"[mesh] rank {rank} 8h olmoe-1b-7b trained at {t['n_layers']} layers, "
              f"model={MESH_TP}: losses {t['losses']} (unsharded {want}, max rel {rel:.3g}), "
              f"on grid {t['grid']}, {[round(s, 3) for s in t['steps_s']]} s a step "
              f"({t['tokens_per_s']:.1f} tokens/s), {t['model_hops']} model hops, param bytes "
              f"{t['param_bytes']} (shards {t['param_bytes_want']}, unsharded "
              f"{base['train']['param_bytes']}), {t['whole_leaves']} leaves whole, peak "
              f"{t['peak_gib']:.2f} GiB, launches {t['launches']}; kernels at the shard shapes "
              f"{r['ep'].get('checks')}", flush=True)
        if t["losses"] != losses or not all(math.isfinite(v) for v in t["losses"]):
            fail(f"mesh phase: rank {rank}'s 8h losses are not finite or differ from rank 0's")
        if not t["grid"]:
            fail(f"mesh phase: rank {rank}'s 8h shards left the grid")
        if not bool((t["replicated"] == ranks[0]["ep"]["train"]["replicated"]).all()):
            fail(f"mesh phase: rank {rank}'s 8h whole leaves (routers, norms) differ from "
                 "rank 0's after the steps")
        if t["param_bytes"] != t["param_bytes_want"]:
            fail(f"mesh phase: rank {rank} holds {t['param_bytes']} parameter bytes in 8h, "
                 f"not its shards' {t['param_bytes_want']}")
        for name in MESH_EP_TRAIN_KERNELS:
            if t["launches"][name] <= 0:
                fail(f"mesh phase: rank {rank}'s 8h training never launched {name}")
    if not rel <= MESH_TP_LOSS_RTOL:
        fail(f"mesh phase: 8h losses {losses} off the unsharded {want} by rel {rel:.3g}")
    return out


def _ep_strip(r: dict) -> None:
    """Drop a rank's 8h tensors and per-token records from the report."""
    for arch in MOE_ARCHS:
        for key in ("pool_sum", *EP_RECORD):
            r["ep"][arch].pop(key, None)
    r["ep"]["train"].pop("replicated", None)


def _ep_launches(r: dict, name: str) -> int:
    """A rank's 8h main-path launches of ``name``: both served archs and
    the training run."""
    return sum(r["ep"][k]["launches"][name] for k in (*MOE_ARCHS, "train"))


# -- 8i. the SSM and RG-LRU blocks at model = 4 ----------------------------------------------


def _shard_bytes(cfg, mesh) -> int:
    """The fp32 bytes of ``cfg``'s parameters a rank of ``mesh`` must hold:
    each split leaf's share, the others whole."""
    import math

    from repro_torch.models.lm import lm_init
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.tree_sharding import leaf_splits, param_splits

    world, meta = int(mesh.shape["model"]), lm_init(cfg, device="meta")
    with sharding_context(mesh):
        splits = leaf_splits(param_splits(cfg, mesh), meta)
    return sum(4 * (math.prod(s.full) // world if s is not None else p.numel())
               for p, s in zip(tree_leaves(meta), splits))


def _pool_bytes_want(eng) -> int:
    """The bytes of ``eng``'s pool a rank must hold: the whole pool's
    layout with each leaf its ``PoolSplit`` splits at its share (a state
    leaf a 1 / model part; an attention leaf's packed values and mask words
    its kv heads' share, its per-block counts whole), the others whole."""
    from repro_torch.runtime.tree_sharding import HEAD_LEAVES
    from repro_torch.serving import kvpool

    split, world = eng.pool_split, int(eng.mesh.shape["model"])
    whole = eng._whole_pool_template(eng.n_slots)
    total = sum(t.numel() * t.element_size() for t in kvpool.pool_leaves(whole["pos"]))
    for key in (k for k in whole if k != "pos"):
        for name, leaf in whole[key].items():
            parts = [t.numel() * t.element_size() for t in kvpool.pool_leaves(leaf)]
            if split is not None and (key, name) in split.states:
                parts = [n // world for n in parts]
            elif split is not None and split.heads is not None and name in HEAD_LEAVES:
                share = len(split.heads.mine), split.heads.n_heads
                parts = [n * share[0] // share[1] for n in parts[:2]] + parts[2:]
            total += sum(parts)
    del whole
    return total


def _ssm_kernel_checks(dev, rank: int, world: int) -> dict:
    """8i's path kernels on this rank at the shard shapes its runs gave
    them, against their plain versions: masked_matmul (tile at the prefill's
    M, skinny at a decode tick's) on mamba2's in_proj and out_proj shards
    and recurrentgemma's wx / wy / wo, local q / k / v / o and SwiGLU
    shards, the tile kernel at each head's vocabulary rows; the train
    path's forward, dx and dw (and split-K) at batch x seq rows;
    flash_attention on the rank's 4 local heads over the one kv head (D
    256, window 2048); ssd_scan on its 12 heads at the prefill's S (rel
    1e-4) and at the train shapes with its autograd wrapper; kv_pack on the
    rings' pool leaf; the strided stochastic_round on a wx column shard
    bit-equal."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.kv_cache.ops import kv_pack, kv_pack_reference
    from repro_torch.kernels.masked_matmul.ops import route
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked
    from repro_torch.kernels.stochastic_round.ops import (shard_counter, sr_reference,
                                                          stochastic_round)
    from repro_torch.models.ssm import _proj_out

    g = torch.Generator(device=dev).manual_seed(100 + rank)
    tag = f"mesh_ssm rank {rank}"
    requests, prompt = MESH_SSM_TRAFFIC[:2]
    tokens = TRAIN_ARCHS_BATCH * TRAIN_ARCHS_SEQ
    mamba, rec = (get_arch(a).resolve(False) for a in MESH_SSM_ARCHS)
    s, d, dd = mamba.ssm, mamba.d_model, rec.d_model
    a = dc.replace(rec.local_attn, n_heads=rec.local_attn.n_heads // world)
    hd, dr, ff = a.head_dim, rec.rglru.d_rnn // world, rec.d_ff // world
    serve = {"in_proj": (d, _proj_out(s) // world), "out_proj": (s.d_inner // world, d),
             "wx / wy": (dd, dr), "wo": (dr, dd), "local q": (dd, a.n_heads * hd),
             "local k / v": (dd, hd // world), "local o": (a.n_heads * hd, dd),
             "gate / up": (dd, ff), "down": (ff, dd)}
    errs = dict.fromkeys(("masked_matmul", "masked_matmul_skinny"), 0.0)
    for m in (prompt, requests):
        key = "masked_matmul" if route(m, 1, 1) == "tile" else "masked_matmul_skinny"
        for kk, n in serve.values():
            errs[key] = max(errs[key], _product_err(g, m, kk, n, tag))
    for kk, n in ((d, mamba.vocab // world), (dd, rec.vocab // world)):
        errs["masked_matmul"] = max(errs["masked_matmul"], _product_err(g, prompt, kk, n, tag))
    torch.cuda.empty_cache()
    got, splits = _train_product_checks(g, {name: (tokens, kk, n)
                                            for name, (kk, n) in serve.items()}, tag)
    for key in ("masked_matmul_dx", "masked_matmul_dw"):
        errs[key] = got[key]
    errs["masked_matmul"] = max(errs["masked_matmul"], got["masked_matmul"])
    errs["flash_attention"] = _flash_err(g, a, prompt, tag)
    h = s.n_heads // world
    x = torch.randn(1, prompt, h, s.head_dim, generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(1, prompt, h, generator=g, device=dev))
    av = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.5)
    b, c = (torch.randn(1, prompt, s.n_groups, s.d_state, generator=g, device=dev)
            .div_(s.d_state**0.5) for _ in range(2))
    with torch.no_grad():
        y, state = ssd_scan(x, dt, av, b, c, return_state=True)
        want_y, want_state = ssd_scan_chunked(x, dt, av, b, c, return_state=True)
    rel = max(float((y - want_y).abs().max() / want_y.abs().max()),
              float((state - want_state).abs().max() / want_state.abs().max()))
    if not rel <= 1e-4:
        fail(f"{tag}: ssd_scan {tuple(x.shape)} off its chunked plain version by rel {rel:.3g}")
    errs["ssd_scan"] = float((y - want_y).abs().max())
    del x, dt, b, c, y, state, want_y, want_state
    errs.update({k: v for k, v in _train_ssd_check(dev, dc.replace(mamba, ssm=dc.replace(
        s, n_heads=h, d_inner=s.d_inner // world))).items() if k == "ssd_scan_grad"})
    ring = torch.relu(torch.randn(rec.n_units, requests, a.window * rec.local_attn.n_kv_heads
                                  * hd, generator=g, device=dev)).to(torch.bfloat16)
    got, want = kv_pack(ring), kv_pack_reference(ring)
    if not all(torch.equal(got[p], want[p]) for p in ("values", "mask", "nnz")):
        fail(f"{tag}: kv_pack on the rings' leaf {tuple(ring.shape)} differs from its plain "
             "version")
    del ring, got, want
    w = torch.randn(dd, dr, generator=g, device=dev)
    base, stride = shard_counter((dd, rec.rglru.d_rnn), 1, rank * dr)
    if not torch.equal(stochastic_round(w, 13, base=base, row_stride=stride),
                       sr_reference(w, 13, base=base, row_stride=stride)):
        fail(f"{tag}: the strided stochastic_round on its wx shard {tuple(w.shape)} differs "
             "from its plain version")
    del w
    _free(dev)
    print(f"[mesh_ssm rank {rank}] 8i kernels at the shard shapes: {errs} over {serve} "
          f"(M {prompt}, {requests} and {tokens}); tile_occupancy, splitk_reduce {splits}, "
          "kv_pack and the strided stochastic_round bit-equal", flush=True)
    return errs


def _ssm_train_spec(spec_path: str, arch: str, world: int = 1):
    from repro_torch.api import build_spec

    mesh = [f"shape.mesh.model={world}"] if world > 1 else []
    return build_spec("train", spec_file=spec_path,
                      sets=[f"arch.id={arch}", *MESH_TP_TRAIN_SETS, *mesh])


def _ssm_runs(mesh, dev, world: int, rank: int, spec_path: str) -> dict:
    """8i on one rank at model = ``world``: mamba2-780m and
    recurrentgemma-9b served whole, then trained (MESH_SSM_TRAIN_UNITS),
    then (on the card) the path kernels at the shard shapes."""
    t0 = time.monotonic()
    out = {"serve": {arch: _ep_serve(dev, arch, _full_units(arch), mesh, MESH_SSM_TRAFFIC)
                     for arch in MESH_SSM_ARCHS},
           "train": {arch: _ep_train(dev, _ssm_train_spec(spec_path, arch, world), mesh,
                                     MESH_SSM_TRAIN_UNITS[arch]) for arch in MESH_SSM_ARCHS}}
    out["runs_s"] = time.monotonic() - t0
    if dev.type == "cuda":
        t0 = time.monotonic()
        out["checks"] = _ssm_kernel_checks(dev, rank, world)
        out["checks_s"] = time.monotonic() - t0
    return out


def _ssm_base(dev, spec_path: str) -> dict:
    """8i's unsharded runs in this process: each arch served on
    MESH_SSM_TRAFFIC, with what 8f's near-tie rule reads
    (:func:`_ep_record`), and trained at MESH_SSM_TRAIN_UNITS."""
    t0 = time.monotonic()
    out: dict = {"serve": {}, "train": {}}
    for arch in MESH_SSM_ARCHS:
        run = _ep_serve(dev, arch, _full_units(arch), traffic=MESH_SSM_TRAFFIC)
        out["serve"][arch] = {k: run[k] for k in ("tokens", "tokens_per_s", "prefill_s",
                                                  "peak_gib", "params", "pool_bytes",
                                                  "state_bytes", *EP_RECORD)}
        out["train"][arch] = _ep_train(dev, _ssm_train_spec(spec_path, arch), units=(
            MESH_SSM_TRAIN_UNITS[arch]))
    out["wall_s"] = time.monotonic() - t0
    for arch in MESH_SSM_ARCHS:
        sv, t = out["serve"][arch], out["train"][arch]
        print(f"[mesh] 8i unsharded {arch}: served {sv['tokens_per_s']:.2f} tokens/s, prefill "
              f"{sv['prefill_s'] / MESH_SSM_TRAFFIC[0]:.3f} s a request, peak "
              f"{sv['peak_gib']:.2f} GiB; trained at {t['n_layers']} layers: losses "
              f"{t['losses']}, {[round(x, 3) for x in t['steps_s']]} s a step, peak "
              f"{t['peak_gib']:.2f} GiB", flush=True)
    print(f"[mesh] 8i unsharded runs {out['wall_s']:.1f} s", flush=True)
    return out


def _ssm_gates(ranks: list, base: dict) -> dict:
    """8i's gates over the model=4 ranks: each served arch's tokens finite,
    equal across ranks and to the unsharded tokens but for a printed near
    tie (8f's rule, :func:`_ep_tie_gate`); each rank's parameter and pool
    bytes its shards' (:func:`_shard_bytes`, :func:`_pool_bytes_want`);
    the training losses finite, bit-equal across ranks and within rel
    MESH_TP_LOSS_RTOL of the unsharded run's, on the grid, the leaves held
    whole the same bits on every rank, each rank's parameter bytes its
    shards'; every path kernel launched on every rank."""
    import math

    out: dict = {}
    for arch in MESH_SSM_ARCHS:
        runs, want = [r["ssm"]["serve"][arch] for r in ranks], base["serve"][arch]
        for rank, e in enumerate(runs):
            print(f"[mesh] rank {rank} 8i {arch} ({e['n_layers']} layers, "
                  f"{e['params'] / 1e9:.3f} B parameters a rank of {want['params'] / 1e9:.3f} B, "
                  f"drawn in {e['init_s']:.1f} s) served at model={MESH_TP}: prefill "
                  f"{e['prefill_s'] / MESH_SSM_TRAFFIC[0]:.3f} s a request (unsharded "
                  f"{want['prefill_s'] / MESH_SSM_TRAFFIC[0]:.3f}), decode {e['decode_s']:.3f} s, "
                  f"{e['tokens_per_s']:.2f} tokens/s (unsharded {want['tokens_per_s']:.2f}), "
                  f"{e['ticks']} ticks, {e['model_hops'] / max(e['ticks'], 1):.1f} model hops a "
                  f"tick, kv heads {e['kv_heads']}, pool {e['pool_bytes']} bytes (unsharded "
                  f"{want['pool_bytes']}), state {e['state_bytes']} bytes (unsharded "
                  f"{want['state_bytes']}), peak {e['peak_gib']:.2f} GiB, card free "
                  f"{e['free_gib']:.2f} GiB, wall {e['wall_s']:.1f} s, launches {e['launches']}",
                  flush=True)
            if e["tokens"] != runs[0]["tokens"] or not e["finite"]:
                fail(f"mesh phase: rank {rank}'s 8i {arch} tokens are not finite or differ "
                     "from rank 0's")
            for name in MESH_SSM_SERVE_KERNELS[arch]:
                if e["launches"][name] <= 0:
                    fail(f"mesh phase: rank {rank}'s 8i {arch} run never launched {name}")
            if e["param_bytes"] != e["param_bytes_want"] or \
                    e["pool_bytes"] != e["pool_bytes_want"]:
                fail(f"mesh phase: rank {rank} holds {e['param_bytes']} parameter and "
                     f"{e['pool_bytes']} pool bytes of 8i's {arch}, not its shards' "
                     f"{e['param_bytes_want']} and {e['pool_bytes_want']}")
        out[arch] = _ep_tie_gate(f"8i {arch}", runs[0], want)
        print(f"[mesh] 8i {arch}: tokens equal to the unsharded run's {out[arch]['equal']}, "
              f"first-step max |logit diff| {out[arch]['first_logit_diff']:.3g}", flush=True)
        t_want = base["train"][arch]
        losses = ranks[0]["ssm"]["train"][arch]["losses"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses, t_want["losses"]))
        out[arch]["loss_rel"] = rel
        for rank, r in enumerate(ranks):
            t = r["ssm"]["train"][arch]
            print(f"[mesh] rank {rank} 8i {arch} trained at {t['n_layers']} layers, "
                  f"model={MESH_TP}: losses {t['losses']} (unsharded {t_want['losses']}, max rel "
                  f"{rel:.3g}), on grid {t['grid']}, {[round(x, 3) for x in t['steps_s']]} s a "
                  f"step ({t['tokens_per_s']:.1f} tokens/s; unsharded "
                  f"{[round(x, 3) for x in t_want['steps_s']]}), {t['model_hops']} model hops, "
                  f"param bytes {t['param_bytes']} (shards {t['param_bytes_want']}, unsharded "
                  f"{t_want['param_bytes']}), {t['whole_leaves']} leaves whole, peak "
                  f"{t['peak_gib']:.2f} GiB (unsharded {t_want['peak_gib']:.2f}), launches "
                  f"{t['launches']}", flush=True)
            if t["losses"] != losses or not all(math.isfinite(v) for v in t["losses"]):
                fail(f"mesh phase: rank {rank}'s 8i {arch} losses are not finite or differ "
                     "from rank 0's")
            if not t["grid"]:
                fail(f"mesh phase: rank {rank}'s 8i {arch} shards left the grid")
            if not bool((t["replicated"] == ranks[0]["ssm"]["train"][arch]["replicated"]).all()):
                fail(f"mesh phase: rank {rank}'s 8i {arch} whole leaves (conv weights, a_log, "
                     "lam, norms) differ from rank 0's after the steps")
            if t["param_bytes"] != t["param_bytes_want"]:
                fail(f"mesh phase: rank {rank} holds {t['param_bytes']} parameter bytes in 8i's "
                     f"{arch} training, not its shards' {t['param_bytes_want']}")
            for name in MESH_SSM_TRAIN_KERNELS[arch]:
                if t["launches"][name] <= 0:
                    fail(f"mesh phase: rank {rank}'s 8i {arch} training never launched {name}")
        if not rel <= MESH_TP_LOSS_RTOL:
            fail(f"mesh phase: 8i {arch} losses {losses} off the unsharded {t_want['losses']} "
                 f"by rel {rel:.3g}")
    for rank, r in enumerate(ranks):
        print(f"[mesh] rank {rank} 8i runs {r['ssm']['runs_s']:.1f} s, kernels at the shard "
              f"shapes {r['ssm'].get('checks_s', 0.0):.1f} s: {r['ssm'].get('checks')}",
              flush=True)
    return out


def _ssm_strip(r: dict) -> None:
    """Drop a rank's 8i tensors and per-token records from the report."""
    for arch in MESH_SSM_ARCHS:
        for key in ("pool_sum", *EP_RECORD):
            r["ssm"]["serve"][arch].pop(key, None)
        r["ssm"]["train"][arch].pop("replicated", None)


def _ssm_launches(r: dict, name: str) -> int:
    """A rank's 8i main-path launches of ``name``: both archs served and
    trained."""
    return sum(r["ssm"][part][arch]["launches"][name] for part in ("serve", "train")
               for arch in MESH_SSM_ARCHS)


def main() -> None:
    # ``--only 5h`` / ``--only 8``: the build and that phase alone (a
    # quick check of the phase; no kernel line and no result line are printed)
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] and len(sys.argv) > 2 else None
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not next to this script ({SRC / 'repro_torch'})")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report: dict = {"device": torch.cuda.get_device_name(0)}

    from repro_torch import kernels
    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels import cuda
    from repro_torch.kernels.masked_matmul.ops import (
        KERNEL_TILES, launch_skinny, launch_tile, masked_matmul, masked_matmul_reference, route,
        tile_occupancy, tile_occupancy_reference, tile_skip_fraction)

    # -- 1. build -------------------------------------------------------------
    t0 = time.monotonic()
    built = cuda.build()
    build_s = time.monotonic() - t0
    for name, info in built.items():
        for line in info["ptxas"]:
            print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(built) or 'already built'} from {cuda.CSRC} in {build_s:.1f}s "
          f"(nvcc {cuda.nvcc_path()})", flush=True)
    report["build_s"] = build_s
    tiles = KERNEL_TILES
    if only in ("5h", "8"):
        if only == "5h":
            report["prune_stash"] = phase_prune_stash(dev, report)
        else:
            report["mesh"] = phase_mesh(dev)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / f"chip_smoke_{only}.json").write_text(json.dumps(report, indent=1,
                                                                    default=float))
        return
    if only is not None:
        fail(f"--only takes 5h or 8, not {only!r}")

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    tm, tn, tk = tiles

    def check_occupancy(a, tile_rows: int, tile_cols: int) -> tuple:
        """masked_matmul's occupancy pre-pass kernel against its plain
        version, exact: (max |kernel - plain| over the flags, empty tiles)."""
        got = tile_occupancy(a, tile_rows, tile_cols)
        want = tile_occupancy_reference(a, tile_rows, tile_cols)
        err = int((got - want).abs().max())
        if err:
            fail(f"tile_occupancy {tuple(a.shape)} disagrees with its plain version")
        return err, int((want == 0).sum())

    # -- 2a. masked_matmul, SR on: exact on coarse-grid operands --------------
    # operands shaped like repro/kernels/masked_matmul/ops.py:52-71: values
    # on the 2**-8 grid, so every product and sum is exact in fp32 and the
    # SR epilogue must agree bit for bit
    def coarse(shape, sparsity):
        v = torch.round(torch.randn(shape, generator=gen) * 2**6) / 2**8
        keep = torch.rand(shape, generator=gen) > sparsity
        return (v * keep).to(dev)

    cases = [(coarse((m, k), 0.5), coarse((k, n), 0.5), 5, True)
             for m, k, n in [(128, 128, 128), (100, 70, 50), (64, 512, 200)]]
    xp, wp = coarse((256, 384), 0.3), coarse((384, 256), 0.3)
    xp[:128, :256] = 0.0  # whole tiles skipped
    wp[256:, 128:] = 0.0
    cases += [(xp, wp, 3, True), (xp, wp, 3, False)]
    occ_err = 0
    for x, w, seed, sr in cases:
        for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
            occ_err = max(occ_err, check_occupancy(a, tr, tc)[0])
        got = masked_matmul(x, w, seed, apply_sr=sr)
        want = masked_matmul_reference(x, w, seed, apply_sr=sr)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.equal(got, want) if sr else err <= 1e-6
        print(f"[masked_matmul] exact-grid {tuple(x.shape)}@{tuple(w.shape)} sr={sr} "
              f"max_abs_err={err:.3g} skip={tile_skip_fraction(x, w, tiles):.3f} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"masked_matmul SR={sr} disagrees with its plain version on the grid case")

    # -- 2b. masked_matmul, SR off: allclose at the serving path's shapes -----
    # Q4.16 operands; fp32 sums in another order differ by at most
    # gamma_K * (|x| @ |w|) per side, gamma_K ~ K * 2**-24: tolerance
    # 2 * K * 2**-24 * (|x| @ |w|), elementwise.  M = 4 and 32 take the
    # skinny kernel, which must give the tile kernel's bits on the same
    # operands (SR off and on); M = 4096 (a long prompt's prefill) takes
    # the tile kernel.
    mm_rows, mm_err = [], 0.0
    for m in (DECODE_M, PREFILL_M, LONG_PROMPT):
        for name, (k, n) in LAYER_SHAPES.items():
            x = quantize_nearest(randn(m, k))
            w = quantize_nearest(randn(k, n) / k**0.5)
            for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
                occ_err = max(occ_err, check_occupancy(a, tr, tc)[0])
            kernel = route(m, n, k)
            got = masked_matmul(x, w, apply_sr=False)
            want = masked_matmul_reference(x, w, apply_sr=False)
            tol = 2 * k * 2.0**-24 * (x.abs() @ w.abs())
            err = (got - want).abs()
            if not bool((err <= tol).all()):
                fail(f"masked_matmul ({m},{k})@({k},{n}) off by {float(err.max()):.3g}")
            mm_err = max(mm_err, float(err.max()))
            if kernel == "skinny":
                for sr in (False, True):
                    if not torch.equal(launch_skinny(x, w, 7, 4, 16, sr),
                                       launch_tile(x, w, 7, 4, 16, sr)):
                        fail(f"masked_matmul ({m},{k})@({k},{n}) sr={sr}: the skinny and the "
                             "tile kernel disagree")
            del tol, want
            # time against cold weights, as decode finds them: rotate copies
            # of w through more than the 50 MB L2
            copies = [w] + [w.clone() for _ in range(max(1, (256 << 20) // (k * n * 4)))]
            cyc = itertools.cycle(copies)
            iters = 50 if m <= PREFILL_M else 5
            ms = timed(lambda: masked_matmul(x, next(cyc), apply_sr=False), iters)
            plain_ms = timed(lambda: masked_matmul_reference(x, next(cyc), apply_sr=False), iters)
            lib_ms = timed(lambda: torch.matmul(x, next(cyc)), iters)
            # the skinny rows: the tile kernel forced on the same operands
            tile_ms = (timed(lambda: launch_tile(x, next(cyc), 0, 4, 16, False), iters)
                       if kernel == "skinny" else ms)
            # the tile kernel's pre-pass alone: both operands' flags
            occ_ms = timed(lambda: (tile_occupancy(x, tm, tk),
                                    tile_occupancy(next(cyc), tk, tn)), iters)
            occ_plain_ms = timed(lambda: (tile_occupancy_reference(x, tm, tk),
                                          tile_occupancy_reference(next(cyc), tk, tn)), iters)
            n_flags = -(-m // tm) * -(-k // tk) + -(-k // tk) * -(-n // tn)
            occ_b_ms, occ_b_by = bound(4.0 * (m * k + k * n + n_flags), m * k + k * n)
            skip = tile_skip_fraction(x, w, tiles)
            b_ms, b_by = bound(4.0 * (m * k + k * n + m * n), 2.0 * m * n * k * (1 - skip))
            tflops = 2.0 * m * n * k / ms / 1e9
            mm_rows.append({"shape": [m, k, n], "proj": name, "route": kernel, "ms": ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms, "tile_ms": tile_ms,
                            "bound_ms": b_ms, "bound_by": b_by, "tflops": tflops,
                            "max_abs_err": float(err.max()), "skip": skip,
                            "occ_ms": occ_ms, "occ_plain_ms": occ_plain_ms,
                            "occ_bound_ms": occ_b_ms, "occ_bound_by": occ_b_by})
            print(f"[masked_matmul] {name:4s} ({m},{k})@({k},{n}) {kernel} kernel "
                  f"err={float(err.max()):.3g}: {ms:.4f} ms ({tflops:.2f} TFLOP/s), "
                  + (f"tile kernel {tile_ms:.4f} ms (bit-equal), " if kernel == "skinny" else "")
                  + f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}); occupancy pre-pass {occ_ms:.4f} ms, plain {occ_plain_ms:.4f} ms, "
                  f"bound {occ_b_ms:.4f} ms ({occ_b_by})", flush=True)
            del copies, x, w, got, err
        torch.cuda.empty_cache()
    report["masked_matmul_shapes"] = mm_rows

    # -- 2b'. block-pruned operands at the widest projection's shape ---------
    # whole tiles of x and w are zero: the pre-pass must flag them empty (an
    # occupancy flag wrongly set would only lose skipping, so it is checked
    # against the plain version) and the product must still agree
    k, n = LAYER_SHAPES["gate"]
    x = quantize_nearest(randn(DECODE_M, k))
    x[:, : k // 4] = 0.0
    keep = (torch.rand(-(-k // tk), -(-n // tn), generator=gen) > 0.5).to(dev)
    keep = keep.repeat_interleave(tk, 0).repeat_interleave(tn, 1)[:k, :n]
    w = quantize_nearest(randn(k, n) / k**0.5) * keep
    empty = 0
    for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
        e, z = check_occupancy(a, tr, tc)
        occ_err, empty = max(occ_err, e), empty + z
    got = masked_matmul(x, w, apply_sr=False)
    want = masked_matmul_reference(x, w, apply_sr=False)
    err = (got - want).abs()
    close = bool((err <= 2 * k * 2.0**-24 * (x.abs() @ w.abs())).all())
    skip = tile_skip_fraction(x, w, tiles)
    print(f"[masked_matmul] block-pruned ({DECODE_M},{k})@({k},{n}): {empty} empty tiles "
          f"flagged as the plain version flags them, skip={skip:.3f} at the kernel's tiles, "
          f"err={float(err.max()):.3g}", flush=True)
    if empty == 0 or skip <= 0.0 or not close:
        fail("masked_matmul on block-pruned operands: no tile skipped or results disagree")
    mm_err = max(mm_err, float(err.max()))

    # -- 2c. mask_pack: both routes exact, timed at the pool's leaves -------
    report["mask_pack"] = mp = phase_mask_pack(dev)

    # -- 3. serve: full-width llama3.2-1b through the port's entry point ------
    from repro_torch.launch.serve import serve_session

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = serve_session("llama3.2-1b", reduced=False, mode="quant_sparse", slots=SLOTS,
                        queue=REQUESTS, prompt_len=PROMPT, gen=GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    serve_wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    done = [r for r in out["per_request"] if r["n_tokens"] == GEN]
    print(f"[serve] llama3.2-1b quant_sparse {SLOTS} slots: {len(done)}/{REQUESTS} requests "
          f"with {GEN} tokens, finite={out['finite']}, tokens_per_s={out['tokens_per_s']:.2f}, "
          f"prefill_s={out['prefill_s']:.3f}, decode_s={out['decode_s']:.3f}, "
          f"decode_steps={out['decode_steps']}, wall {serve_wall:.1f}s", flush=True)
    print(f"[serve] launches {launches}; kv wire {out['kv_mean_wire_bytes']:.0f} B/step mean, "
          f"density {out['kv_mean_density']:.3f}, "
          f"{out['kv_traffic_reduction_vs_fp32']:.2f}x less than a dense fp32 pool", flush=True)
    report["serve"] = {k: v for k, v in out.items() if k not in ("per_request", "generated")}
    report["serve"]["tokens"] = [r["tokens"] for r in out["per_request"]]
    report["launches"] = launches
    if len(done) != REQUESTS or not out["finite"]:
        fail("serve phase: not every request finished with finite logits")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"serve phase never launched the {name} kernel")
    if launches["tile_occupancy"] != 0:
        fail("serve phase (M <= 32 throughout) launched the tile kernel's occupancy pre-pass")
    report["decode_profile"] = profile_decode(dev)

    # -- 3c. spec: the example spec through the port's launcher ---------------
    report["spec"] = spec_run = phase_spec(dev)

    # -- 4. check: reduced model on the card vs the CPU plain versions --------
    report["check"] = check_lm_card_vs_cpu(dev, gen, "llama3.2-1b", 12)

    # -- 5. slice 2: CNN training ----------------------------------------------
    report["stochastic_round"] = sr = phase_stochastic_round(dev, gen)
    report["backward"] = bwd = phase_backward(dev, gen)
    report["train"] = train = phase_train(dev)
    report["cnn_card_vs_cpu"] = phase_cnn_card_vs_cpu(dev)
    report["arms"] = phase_arms(dev)
    report["train_lm"] = train_lm = phase_train_lm(dev)
    report["train_archs"] = train_archs = phase_train_archs(dev)

    # -- 6. slice 3: long-prompt prefill, Mamba-2 ------------------------------
    report["flash_attention"] = fa = phase_flash_attention(dev, gen)
    report["ssd_scan"] = ssd = phase_ssd_scan(dev, gen)
    report["serve_long"] = serve_long = phase_serve(
        dev, "llama3.2-1b", LONG_SLOTS, LONG_REQUESTS, LONG_PROMPT, LONG_KERNELS, "serve_long")
    report["decode_profile_long"] = profile_decode(dev, LONG_PROMPT, ticks=3)
    report["serve_mamba2"] = serve_mamba2 = phase_serve(
        dev, "mamba2-780m", MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_PROMPT, MAMBA_KERNELS,
        "serve_mamba2", late=MAMBA_LATE)
    report["check_long"] = {arch: check_lm_card_vs_cpu(dev, gen, arch, CHECK_PROMPT)
                            for arch in ("mamba2-780m", "llama3.2-1b")}
    report["prefill_profile"] = {
        "llama3.2-1b": profile_prefill(dev, "llama3.2-1b", LONG_PROMPT),
        "mamba2-780m": profile_prefill(dev, "mamba2-780m", MAMBA_PROMPT)}

    # -- 6g. slice 9: spill/resume, rescale, snapshots, chaos, sampling --------
    report["survive"] = survive = phase_survive(dev)

    # -- 6h/6i. slice 10: the paged pool, minitron-4b, mistral-nemo-12b ---------
    report["paged"] = paged = phase_paged(dev)
    report["archs"] = archs = phase_archs(dev, gen)

    # -- 6j. slice 13: recurrentgemma-9b (RG-LRU, D 256 windowed attention), qwen2-7b
    report["hybrid"] = hybrid = phase_hybrid(dev, gen)

    # -- 6k. slice 14: olmoe-1b-7b and deepseek-v2-lite-16b (MoE FFN, MLA) -------
    report["moe"] = moe = phase_moe(dev, gen)

    # -- 6l. slice 15: whisper-medium, internvl2-26b's image prefix, the int8 cache
    report["slice15"] = s15 = phase_slice15(dev, gen)

    # -- 7. slice 4: the kernel sweep and the paper evaluation -----------------
    report["dangling_filter"] = df = phase_dangling_filter(dev, gen)
    report["sweep"] = sweep = phase_sweep(dev)
    report["paper"] = paper = phase_paper(dev)

    # -- 5h. slice 17: magnitude pruning and the lossy stash (run last: its
    # full-width runs leave the earlier phases' memory as they found it)
    report["prune_stash"] = prune_stash = phase_prune_stash(dev, report)

    # -- 8. slice 18: the mesh (ranks on this card, after every one-process phase)
    report["mesh"] = mesh = phase_mesh(dev, {arch: {"tokens": moe[arch]["monolithic"]["tokens"],
                                                    **moe[arch]["monolithic"].pop("record")}
                                             for arch in MOE_ARCHS})

    # -- kernel line, card, result -------------------------------------------
    # launches: the sum over the main paths' runs (serve, spec, train,
    # train_lm, train_archs, prune_stash, serve_long, serve_mamba2, survive, paged, archs, hybrid, moe,
    # slice15, the kernel sweep, the paper path's probe, and the mesh's runs summed over
    # its ranks), each zeroed just before its run and read just after (the comparisons
    # above count in none)
    by_path = {name: {"serve": launches[name], "spec": spec_run["launches"][name],
                      "serve_long": serve_long["launches"][name],
                      "serve_mamba2": serve_mamba2["launches"][name],
                      "survive": survive["launches"][name],
                      "paged": paged["launches"][name], "archs": archs["launches"][name],
                      "hybrid": hybrid["launches"][name], "moe": moe["launches"][name],
                      "slice15": s15["launches"][name],
                      "train": train["launches"][name],
                      "train_lm": train_lm["launches"][name],
                      "train_archs": train_archs["launches"][name],
                      "prune_stash": prune_stash["launches"].get(name, 0),
                      "sweep": sweep["launches"][name],
                      "paper": paper["launches"][name],
                      "mesh": mesh["launches"][name],
                      "mesh_tp": mesh["tp_launches"][name]}
               for name in launches}
    total = {name: sum(v.values()) for name, v in by_path.items()}

    def bwd_entry(op: str) -> dict:
        rows = [r for r in bwd["rows"] if r["op"] == op]
        return {"name": f"masked_matmul_{op}", "route": "cuda",
                "source": "src/repro_torch/csrc/masked_matmul.cu",
                "replaces": "src/repro/kernels/masked_matmul/backward.py:85",
                "launches": total[f"masked_matmul_{op}"],
                "max_abs_err": max(bwd["err"][op], mesh["errs"]["tp"][op]),
                "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                # the kind that bounds most of the summed bound
                "bound_by": max(("operations", "bytes"), key=lambda by: sum(
                    r["bound_ms"] for r in rows if r["bound_by"] == by)),
                "library_ms": sum(r["library_ms"] for r in rows),
                "shape": f"VGG-19 batch {VGG_BATCH} backward {op} of c0_1 + c3_0 + fc6 "
                         "(per-layer rows, each with its route, in chip_smoke.json)",
                "launches_by_path": by_path[f"masked_matmul_{op}"]}

    decode_rows = [r for r in mm_rows if r["shape"][0] == DECODE_M]
    prefill_rows = [r for r in mm_rows if r["shape"][0] == LONG_PROMPT]
    fa_main = next(r for r in fa["rows"] if (r["seq"], r["head_dim"]) == (LONG_PROMPT, FA_DIM))

    def layer_entry(rows, pre: str = "") -> dict:
        return {"ms": sum(r[pre + "ms"] for r in rows),
                "plain_ms": sum(r[pre + "plain_ms"] for r in rows),
                "bound_ms": sum(r[pre + "bound_ms"] for r in rows),
                "bound_by": max(("operations", "bytes"), key=lambda by: sum(
                    r[pre + "bound_ms"] for r in rows if r[pre + "bound_by"] == by))}

    line = {"kernels": [
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": total["masked_matmul"],
         "max_abs_err": max(mm_err, archs["errs"]["masked_matmul"], mesh["errs"]["masked_matmul"],
                            mesh["errs"]["tp"]["forward"],
                            prune_stash["train_checks"]["forward"],
                            hybrid["errs"]["masked_matmul"], spec_run["errs"]["masked_matmul"],
                            moe["errs"]["masked_matmul"], s15["errs"]["masked_matmul"]),
         **layer_entry(prefill_rows),
         "library_ms": sum(r["library_ms"] for r in prefill_rows),
         "shape": f"the tile kernel (masked_mm_kernel): one prefill layer, q,k,v,o,gate,up,down "
                  f"at M={LONG_PROMPT}, the wrapper's time with its occupancy pre-pass",
         "note": "launches: every forward product, on either kernel; those with M <= 32 are "
                 "also counted under masked_matmul_skinny",
         "launches_by_path": by_path["masked_matmul"]},
        {"name": "masked_matmul_skinny", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": total["masked_matmul_skinny"],
         "max_abs_err": max(mm_err, archs["errs"]["masked_matmul_skinny"],
                            prune_stash["serve_checks"]["masked_matmul_skinny"],
                            hybrid["errs"]["masked_matmul_skinny"],
                            spec_run["errs"]["masked_matmul_skinny"],
                            moe["errs"]["masked_matmul_skinny"],
                            s15["errs"]["masked_matmul_skinny"], mesh["errs"]["tp"]["skinny"]),
         **layer_entry(decode_rows),
         "library_ms": sum(r["library_ms"] for r in decode_rows),
         "tile_ms": sum(r["tile_ms"] for r in decode_rows),
         "shape": f"the skinny kernel (masked_mm_skinny_kernel): one decode layer, "
                  f"q,k,v,o,gate,up,down at M={DECODE_M}, cold weights, the wrapper's time",
         "note": "every product with M <= 32 (forward, dx, dw); bit-equal to the tile kernel "
                 "on the same operands; tile_ms: the tile kernel forced on them",
         "launches_by_path": by_path["masked_matmul_skinny"]},
        {"name": "tile_occupancy", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/ops.py:43",
         "launches": total["tile_occupancy"], "max_abs_err": float(occ_err),
         **layer_entry(prefill_rows, "occ_"), "library_ms": None,
         "shape": f"one prefill layer: x and w flags of the 7 projections at M={LONG_PROMPT}",
         "note": "the tile kernel's occupancy pre-pass (the jnp _occupancy ahead of "
                 "masked_matmul_pallas), two launches per product with M > 32",
         "launches_by_path": by_path["tile_occupancy"]},
        {"name": "mask_pack", "route": "cuda",
         "source": "src/repro_torch/csrc/mask_pack.cu",
         "replaces": "src/repro/kernels/mask_compress/mc_kernel.py:36",
         "launches": total["mask_pack"], "library_ms": None,
         **{k: mp[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "lane_ms", "lane_device_ms", "host_ms", "floor_ms",
                               "host_split", "rows")},
         "shape": f"one 4096-token decode-tick KV leaf ({16 * LONG_SLOTS},"
                  f"{(LONG_PROMPT + GEN + 1) * KV_ROW}) bf16, the stream route",
         "note": "ms and lane_ms: a timed loop of calls; device_ms and lane_device_ms: one "
                 "call's kernel with L2 flushed ahead of it (lane: the lane route forced on "
                 "the same input); host_ms: the host's time to queue one call at the "
                 "prompt-32 decode leaf, host_split its parts; floor_ms: a one-word call's "
                 "device time; rows: the prompt-32 decode leaf, this leaf and the 4096-token "
                 "install row",
         "launches_by_path": by_path["mask_pack"]},
        bwd_entry("dx"),
        bwd_entry("dw"),
        {"name": "splitk_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": total["splitk_reduce"], **bwd["reduce"],
         "note": "masked_matmul's split-K reduce, one launch per product with K > 8192; "
                 "the Pallas kernel carries its K sum across the sequential grid axis; "
                 "library: torch.sum(partials, 0); ms and library_ms: a timed loop of calls; "
                 "device_ms and library_device_ms: one call's kernel with L2 flushed ahead "
                 "of it, to hold against the byte bound; host_ms and library_host_ms: the "
                 "host's time to queue one call",
         "launches_by_path": by_path["splitk_reduce"]},
        {"name": "stochastic_round", "route": "cuda",
         "source": "src/repro_torch/csrc/stochastic_round.cu",
         "replaces": "src/repro/kernels/stochastic_round/sr_kernel.py:51",
         "launches": total["stochastic_round"], **sr, "library_ms": None,
         "launches_by_path": by_path["stochastic_round"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/fa_kernel.py:99",
         "launches": total["flash_attention"],
         "max_abs_err": max(fa["err"], archs["errs"]["flash_attention"],
                            hybrid["errs"]["flash_attention"],
                            spec_run["errs"]["flash_attention"], moe["errs"]["flash_attention"],
                            s15["errs"]["flash_attention"], mesh["errs"]["tp"]["flash_attention"]),
         **{k: fa_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "device_ms", "host_ms", "library_device_ms", "tile")},
         "shape": f"one llama3.2-1b prefill attention: B 1, H {FA_HEADS}, HKV {FA_KV_HEADS}, "
                  f"D {FA_DIM}, S {LONG_PROMPT}, causal, fp32; library: fp32 "
                  "scaled_dot_product_attention (enable_gqa, is_causal)",
         "note": "ms and library_ms: a timed loop of calls; device_ms and library_device_ms: "
                 "one call with L2 flushed ahead of it; host_ms: the host's time to queue a "
                 "call; tile: the query tile the wrapper's plan chose; every row of 6a in "
                 "chip_smoke.json",
         "launches_by_path": by_path["flash_attention"]},
        {"name": "flash_attention_d256", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/fa_kernel.py:99",
         "launches": total["flash_attention_d256"],
         "max_abs_err": hybrid["errs"]["flash_attention_d256"],
         **{k: hybrid["fa256"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms", "device_ms", "host_ms",
                                            "library_device_ms", "tile")},
         "shape": f"one recurrentgemma-9b local attention: B 1, H 16, HKV 1, D 256, "
                  f"S {FA256_S}, causal, window 2048, fp32; library: fp32 "
                  "scaled_dot_product_attention (enable_gqa, a boolean band mask)",
         "note": "the D 256 instantiation of flash_attention.cu (D split over two warp "
                 "groups); its launches are also counted under flash_attention; "
                 "max_abs_err: here and at the served prompt (S 2600); ms and library_ms: "
                 "a timed loop of calls; device_ms and library_device_ms: one call with L2 "
                 "flushed ahead of it; host_ms: the host's time to queue a call",
         "launches_by_path": by_path["flash_attention_d256"]},
        {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_kernel.py:71",
         "launches": total["ssd_scan"], **ssd, "library_ms": None,
         "max_abs_err": max(ssd["max_abs_err"], mesh["errs"]["tp"]["ssd_scan"]),
         "note": "one counted launch per call runs four stage kernels: chunk scores (once "
                 "per group), chunk state, state passing, chunk scan; ms: a timed loop of "
                 "calls; device_ms: one call's kernels with L2 flushed ahead of it; stage "
                 "times in chip_smoke.json",
         "launches_by_path": by_path["ssd_scan"]},
        {"name": "dangling_filter", "route": "cuda",
         "source": "src/repro_torch/csrc/dangling_filter.cu",
         "replaces": "src/repro/kernels/mask_compress/mc_kernel.py:58",
         "launches": total["dangling_filter"], **df, "library_ms": None,
         "note": "on the kernel sweep's path alone: the model paths (serve, serve_long, "
                 "serve_mamba2, train) launch it 0 times, as the reference's model code "
                 "never calls it; no single PyTorch call computes it",
         "launches_by_path": by_path["dangling_filter"]},
    ]}
    report["kernels"] = line["kernels"]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    report["nvidia_smi"] = smi
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
