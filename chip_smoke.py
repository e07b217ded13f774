#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; imports nothing of JAX
or of the JAX package.  Exits non-zero, printing no result, when CUDA is
missing, when run outside the repository, or when any phase fails.
Phases, each timed with CUDA events:

1. build the kernels from ``src/repro_torch/csrc`` (nvcc, one process per
   source, all started together); print ptxas's registers, stack frame and
   spills of every entry function and its warnings; fail if the attention
   kernel's hd-128 TMA + wgmma instantiation spills;
2. each swarm kernel against its plain PyTorch version, on the card, at the
   swarm round's full-width shapes (N = 10 nodes, D = 162,417,408) and at
   ragged ones (N = 3, D not a multiple of a block; k = 1, an even k, all
   rows masked): the median bit-equal, CenteredClip within 3e-5, krum's d2
   selection-equal and within 1e-5 of the squared norms of both its plain
   version and a float64 gram, decode-accumulate bit-equal on a 64- and a
   127-level wire; at full
   width, the masked CenteredClip chain of 3 iterations (the fused
   aggregator's) bit-equal to three single-iteration calls and to a second
   chain, and within 3e-5 of three plain iterations, on every mask, fixed
   and adaptive tau; the median at every kept count K = 0..10, bit-equal;
   the median and krum_d2 captured in a CUDA graph and replayed at K = 10,
   7, 0 and 4 (the mask copied into the captured buffer), equal to eager
   calls;
2b. the QSGD encode kernel against its plain version at the showcase's
   wire (one node's D values, buckets of 512, 127 levels; 317,222 buckets,
   the last ragged), at compressed_wire's 64 / 512, at the global-norm
   surface (ceil(D / 128) lanes, one norm) and at ragged lengths (7, 1,000,
   255; levels 16, 64, 127), codes equal; the unmasked CenteredClip
   iteration against its plain version at (10, D) and at k = 1, 2, 3, 7 with
   D = 257 and 1,000, fixed and adaptive tau, within 3e-5, two launches
   bit-equal; at each of those shapes the unmasked chain of 3 iterations
   bit-equal to three single-iteration calls and to a second chain, and
   within 3e-5 of three plain iterations;
3. the sliding-window attention kernel against its plain version at the
   prefill's shape (B 1, S 32,768, H 32 / Hkv 8, hd 80, window 4,096, bf16),
   at zamba2's full causal shape (B 1, S 32,768, H 32 / 32, hd 64,
   window = S, bf16), at mixtral's band (B 1, S 32,768, H 32 / 8, hd 128,
   window 4,096), qwen3-moe's causal triangle at hd 128 (H 32 / 4, window
   = S = 4,099) and granite's MQA (H 48 / 1, hd 128, window = S = 4,099),
   each in bf16 and float32, and at ragged ones (S not a multiple of the tile or
   below one, a window below a tile or not a multiple of one or at least S,
   hd 64 / 80 / 128, B 2, float32 and bfloat16), each case's kernel printed
   as the C dispatcher reports it (``swa_attention_path``) and held to the
   route (bf16 at hd 64, 80 and 128 with S of at least one 128-key tile:
   the TMA ring + wgmma; other bf16: mma.sync; float32: CUDA cores):
   within 2e-2 in bf16 and
   2e-4 in f32 elementwise, two launches bit-equal; in bf16 also within
   6e-4 mean row relative L2 (L2 over the head dim, each query and head a
   row), a bound that the plain version with p rounded to bf16 (a control,
   computed at every bf16 case) must exceed, so the check tells the
   kernel's fp32 p.v (the hi/lo split of p) from a bf16 one;
3b. the WKV kernel against its plain version at rwkv6-1.6b's served shape
   (B 1, S 32,768, H 32, K 64, bf16) and at ragged ones (S = 1, S at the
   64-token chunk's boundaries 63, 64, 65 and 197, S not a multiple of the
   chunk, K 32 / 64 / 128, float32 and bfloat16, a non-zero initial state,
   strong decay): y within 1e-4 relative L2 in float32 and the ops
   module's ``BF16_REL`` in bfloat16, a bound that the plain version with
   its float32 product operands rounded to bf16 (a control, the single-pass
   design, computed at every bf16 case) must exceed at the served shape and
   under strong decay, so the check tells the kernel's hi/lo split from one
   bf16 pass; s_final within 1e-4; two launches bit-equal;
3c. the SSD scan kernel against its plain version at zamba2-1.2b's served
   shape (B 1, S 32,768, H 64, P 64, N 64, bf16) and at ragged ones (S = 1,
   63, 64, 65, 197, 1,040 and the prime 997, P 16 / 32 / 48 / 64 / 80, N
   16 / 48 / 64 / 128, H not a multiple of the kernel's head group, float32
   and bfloat16, a non-zero initial state, strong decay): y within 1e-4
   relative L2 in float32, and in bfloat16 within one bf16 rounding
   elementwise and the ops module's ``BF16_REL`` relative L2, a bound that
   its bf16-operand control must exceed at the served shape and under
   strong decay; h_final within 1e-4; two launches bit-equal;
4. the swarm's main path: ``python -m repro_torch.launch.swarm --full
   --rounds 3`` (the showcase: protocol-125m at full width, 10 nodes, QSGD
   wire, CenteredClip, audits), with finite loss, only Byzantine nodes
   slashed and a conserving ledger; the launcher's custody checkpoint of
   the trained params (16 shards, redundancy 2, no holder over 40%)
   restored by every holder bit-equal to ``eval_params()``, two holders
   refused with ``PermissionError``, the seconds of both printed;
4d. the custody lane at full width: the showcase's roster and config with
   custody_leech's ``CustodyConfig(num_shards=16, redundancy=2,
   max_fraction=0.4, coalition_fraction=0.25)`` for 3 rounds: phase 4's
   launches, and params, slashed, contrib and records bit-equal to phase
   4's run (custody only observes); each round's coverage equal to the host
   custody matrix's over the active nodes; the reconstruct attack of the
   coalition (the last 3 slots) keeping exactly its shards and zeroing the
   rest, its loss printed beside the honest one and log V;
5. one more full-width round on each config that reaches the other swarm
   kernels: krum (krum_d2), the compressed-wire scenario's mean over a
   64-level QSGD wire (decode-accumulate; a second round under
   torch.profiler gives its device time and the decode kernel's share),
   sign_flip_minority's adaptive-τ CenteredClip;
6. fused against unfused: one showcase round from the same state with the
   same draws; equal audits and masks, close aggregate and params; then two
   more showcase rounds timed, and one under torch.profiler (device time by
   kernel, the device's busy share, and the mean time of each of the
   CenteredClip chain's three launch kinds, held to 1 + 2 x 3 launches);
4b. the sequential engine's path: ``python -m repro_torch.launch.swarm
   --full --rounds 3 --engine sequential`` (the showcase on the per-node
   ``SequentialSwarm``: the dense median warm start and the unmasked
   CenteredClip kernel over the compacted survivors), with phase 4's checks
   and its peak memory; one round under torch.profiler, as phase 6's;
6c. the sequential engine against the batched one at full width: round 0
   of the showcase from the same init and seed (so the same draws); equal
   ``n_active``, ``caught`` and minted nodes, the two aggregates within
   1e-5 relative L2;
4c. the decentralized round: ``python -m repro_torch.launch.swarm --full
   --scenario byzantine_neighborhood --nodes 10 --rounds 2`` (protocol-125m
   at full width, per-node replicas and AdamW states, a degree-4
   random-regular graph, 2 sign-flip attackers, CenteredClip): 10 medians
   and 30 CenteredClip iterations a round, node 3's round-1 aggregate
   bit-equal to a lone ``masked_centered_clip_fused`` call with its mask
   and within 3e-5 of the plain version, finite consensus error; two more
   rounds on CUDA events and their peak memory, one profiled (busy share); then
   round 0 of the roster on ``fully_connected`` against the centralized
   round from the same init, agg_norm and the consensus replica's update
   within 2e-3 (``tests/test_topology.py:160``'s bound);
4e. the async round at full width: ``python -m repro_torch.launch.swarm
   --full --scenario stale_poisoning --nodes 10 --rounds 4`` (8 honest
   nodes and 2 sign-flip attackers that may lag 3 rounds, CenteredClip,
   audits at p 0.25, staleness bound 3): 4 medians and 12 iterations;
   each round's staleness equal to the mean, over its active nodes, of the
   delays the host draws from the same schedule (each at most min(cap,
   round, 3)); the row a stale attacker submitted in the round of the
   largest delay bit-equal to its gradient recomputed alone at its
   snapshot, sign-flipped; no honest node slashed; two more rounds on CUDA
   events and the phase's peak memory;
4f. the economy lane at full width: ``python -m repro_torch.launch.swarm
   --full --scenario economy_sybil_adaptive --nodes 10 --rounds 3`` (5
   honest nodes and a coalition of 5 inner-product identities, all funded
   from the 50-unit budget at cost 0.1 + bond 5, so stakes 9.9 against the
   honest 5.0; CenteredClip, audits at p 0.1, the adaptive best
   response): each round the lane's own CenteredClip and the 4 scored
   ones, 15 medians and 45 iterations; round 0's four scored aggregates
   within 3e-5 of ``core.aggregation``'s unfused masked CenteredClip on
   the same stacks, the same best scale, which the coalition then
   submitted; the conservation gap at most 1e-4 of the inflow after every
   round; two more rounds on CUDA events and their peak memory;
10. the §5.5 sweep: ``derailment.sweep`` of the ``no_off_smoke`` grid
   (mean and CenteredClip against 2 and 6 inner-product attackers beside
   6 honest nodes, and the honest baseline: 5 lanes of one campaign, 8
   rounds) on ``launch.problems.tiny_quadratic_problem`` on the card (its
   CenteredClip lanes through the masked median and the chain) and on the
   CPU from the same bits: the phase tables equal as strings, each cell's
   ``derailed`` and ``attackers_slashed`` equal, finite final and baseline
   losses within 1e-4 relative;
10b. the same grid as one campaign at protocol-125m's full width (the
   showcase's problem and AdamW at 5e-3; 5 lanes of N = 12, each round a
   (12, 162,417,408) float32 stack), rounds cut from 8 to 2: the lanes of
   mean with 2 attackers and CenteredClip with 6 bit-equal to the
   single-run Swarm that ``simulate_derailment`` builds for the cell on
   the sweep's baseline (params, slashed, contrib, the history, the kept
   rounds) and the sweep's peak memory; then every lane run again alone by
   ``make_scan_program`` from the same batches, its records and params
   bit-equal to the campaign's lane and each round timed with CUDA events
   (the s per lane-round, set-up and evals left out); three more rounds of
   the CenteredClip Swarm timed and one profiled for the device's busy
   share of the median round; last the sweep as a user calls it (no
   lane's params kept), its peak memory, its table and losses equal;
10c. the small LM: the ``no_off_lm`` grid of ``launch/derailment_no_off.py``
   (mean, CenteredClip and mean under audits at p 0.5 against 1, 4 and 10
   inner-product attackers at scale 20 beside 8 honest nodes, and the
   baseline: 10 lanes of N = 18) on ``launch.problems.small_lm_problem``,
   rounds cut from 30 to 6: the card run free as a user calls it (the CPU
   run's audit draws handed in; its 3 CenteredClip lanes launch a median
   and a chain each round), then each round of the card run from the CPU
   run's state, lane by lane: discrete fields equal, agg_norm within 1e-3
   until the model blows up (an aggregate norm of 1e3), final losses within
   1e-4 up to a loss of 100, both within 2e-3 past those (and finite on
   both sides or neither), the tables from the
   CPU run and from the card's rounds equal as strings; the free run's
   table is printed beside them;
10d. the decentralized sweep: ``no_off_topology_smoke`` (CenteredClip on a
   ring and on the complete graph against 2 and 6 attackers beside 6
   honest, 8 rounds, baselines per topology) on the tiny quadratic, card
   (one median and chain for each node with a kept neighbour, 368) against
   CPU, held as phase 10;
10e. the async sweep: ``no_off_async_smoke`` (CenteredClip at staleness
   bounds 0 and 2 against 2 and 6 attackers beside 6 honest, 8 rounds,
   baselines per bound) on the tiny quadratic, card (32 medians and 96
   iterations) against CPU, held as phase 10: the delays are drawn on the
   host, so both draw the same;
10f. the custody sweep: ``custody_smoke`` (mean, redundancy 1 and 2
   against coalitions of half and all of 6 honest nodes, a third churning
   out, the reconstruct attack in every lane) on the tiny quadratic, card
   against CPU: the extractability and phase tables equal as strings, the
   coverage traces exactly, the final and extracted losses within 1e-4;
10g. the economy sweep: ``no_off_economy_smoke`` (mean and CenteredClip
   under audits at p 0.25 against a coalition of 3 beside 6 honest, two
   identity costs, two fees, fixed and adaptive, 8 rounds, the baseline:
   17 lanes) on the tiny quadratic, the card given the CPU run's audit
   draws: the phase tables and both regimes' economy tables (fixed and
   adaptive) equal as strings, each cell's outcome and admitted counts
   equal, losses and payoffs within 1e-4, the adaptive gap over 8 cells;
   its fixed CenteredClip lanes launch one median and chain a round, its
   adaptive ones 5 (the 4 scored scales and the round's own);
10h. the serving sweep: ``serving_smoke`` (2 loads x 2 churn rates x 2
   redundancies, 8 lanes of 8 requests through 3 slots, 48 steps) on the
   1-layer protocol-125m of ``launch/serving_no_off.py``, card against CPU:
   the availability tables equal as strings, the cells equal, one lane's
   tokens and records equal through ``ServingEngine.run``; then the reduced
   windowed danube (window 8, so each row's ring wraps), rwkv6, zamba2,
   mixtral, qwen3-moe (k = 8 of 16 experts), qwen2-vl, stablelm,
   tinyllama and granite engines (float32) on one lane with a coverage
   outage, card against CPU, tokens and records equal;
7. the serving path (``protocol_serve``): ``python -m
   repro_torch.launch.protocol_inference --arch h2o-danube-1.8b --full
   --seq 32768 --batch 1`` (1,831,201,280 params; 8 nodes, 16 custody
   shards, redundancy 2, max fraction 0.35): refused without credentials,
   served logits bit-equal to ``Model.prefill(params)`` with the full swarm
   and with one node offline, ``ExtractionError`` at 2 nodes, a 3-node
   coalition's extraction far from the true logits; then ``decode`` of the
   first 392 tokens of 4 prompts of 4,160, 32 new tokens, on the
   reassembled params (equal to the true ones leaf for leaf);
7b. the ring-buffer decode against the kernel prefill across the wrap,
   teacher-forced on the 4,160-token prompts (the 4,096-slot ring wraps 64
   positions before they end): each layer's update over the 128 stepped
   positions around the wrap, and the last position's logits, within 1e-2
   relative L2;
8. the kernel route against the ``_swa`` route (``use_pallas_kernels``
   off) on the same full-width prefill: teacher-forced, each layer's update
   and the last layer's logits within 1e-2 relative L2; free-running, the
   kernel route's logit gap held to at most twice the gap between two
   routes without the kernel (``_swa`` and ``swa_attention_plain``), which
   shows how far the random model's chaos parts any two float orders;
7g. the continuous-batching engine at full width: ``python -m
   repro_torch.launch.serve --driver engine --arch h2o-danube-1.8b --full
   --batch 16 --slots 8 --prompt-len 64 --max-new 16`` (every request done),
   then one custody-gated ``ServingEngine.run`` on the same model and
   prompts (protocol_serve's custody matrix, prompts of 32-64 tokens,
   budgets of 4-16, one arrival a step, both holders of shard 0 down over
   steps [20, 40), 200 steps) and the same lane stepped by hand with
   ``make_serve_step`` under ``torch.cuda.set_sync_debug_mode("error")``
   (no host sync inside a step), equal to the run field for field: every
   request done, the coverage trace equal to numpy's, the dead steps
   exactly [20, 40) with nothing admitted or delivered on them, serving
   resumed after; the records equal to the same lane's on the CPU with the
   reduced model; at mid-horizon, layers 0 and 1 of each occupied slot's
   K/V within 1e-2 relative L2 of the request stepped alone (B = 1); the
   engine's tok/s and ms a step printed beside phase 7's decode;
7c. the serving path on rwkv6 (``protocol_serve_rwkv6``): ``python -m
   repro_torch.launch.protocol_inference --arch rwkv6-1.6b --full --seq
   32768 --batch 1`` (1,590,235,136 params built), with phase 7's checks;
   one served prefill under torch.profiler (device time by kernel, and
   the mean time of each of the WKV kernel's three launches); then
   ``decode`` of 4 prompts of 392 tokens (not a multiple of a chunk), 32
   new tokens;
7d. decode against the kernel prefill on a float32 copy of the full-width
   params (where prefill's bf16 cast of w does nothing): each layer's
   recurrent state after stepping the 392-token prompts within 1e-4
   relative L2 of the kernel's s_final, the last logits within 1e-3; the
   bf16 gap of the served params (the reference's quirk) is printed, not
   held;
8b. the WKV kernel route against the ``wkv_chunked`` route on the served
   32,768-token prefill: teacher-forced, each layer's update and the
   logits within 1e-2 relative L2; free-running, the kernel route's logit
   gap at most twice the gap between two routes without the kernel
   (``wkv_plain`` and ``wkv_chunked``);
7e. the serving path on zamba2 (``protocol_serve_zamba2``): ``python -m
   repro_torch.launch.protocol_inference --arch zamba2-1.2b --full --seq
   32768 --batch 1`` (1,170,157,696 params built: 38 Mamba2 layers, the
   shared attention block, with no window, after each group of 6), with
   phase 7's checks and a peak memory far below the 128 GiB that one
   (32,768 x 32,768) float32 score matrix of 32 heads would take; the
   shared block's attention runs the sliding-window kernel at window = S
   (6 launches a prefill); one served prefill under torch.profiler (device
   time by kernel, and the mean time of each of the SSD kernel's three
   launches); then ``decode`` of 4 prompts of 392 tokens, 32 new tokens;
7f. decode against the kernel prefill on a float32 copy of the full-width
   params, teacher-forced: each layer stepped through the 392-token
   prompts from the prefill's input to it; each mamba layer's SSD state
   within 1e-4 relative L2 of the kernel's h_final, each application's K/V
   cache equal to the prefill's k, v within 1e-5, each layer's update and
   the last logits within 1e-3; the free-running gaps are printed;
8c. the SSD kernel route against the ``ssd_chunked`` route on the served
   32,768-token prefill: teacher-forced, each layer's update and the
   logits within 1e-2 relative L2; free-running, the kernel route's logit
   gap at most twice the gap between two routes without the kernel
   (``ssd_plain`` and ``ssd_chunked``, both with the blockwise attention),
   or 1e-2;
8d. the shared block's attention kernel route against the blockwise route
   (``use_pallas_kernels`` off) on the served zamba2 prefill:
   teacher-forced, at each of the block's 6 applications both routes take
   the kernel route's input, and the update and the last logits agree
   within 4e-3 relative L2;
7h. the serving path on mixtral (``protocol_serve_mixtral``): ``python -m
   repro_torch.launch.protocol_inference --arch mixtral-8x7b --full
   --layers 3 --seq 32768 --batch 1`` (full width, the depth cut to 3 of
   32 layers: 4,615,958,528 params built, the cut config's
   ``param_count()``), with phase 7's checks and 3 window-kernel launches
   a prefill; the slots its MoE drops at capacity factor 1.25 printed;
   then ``decode`` of 4 prompts of 392 tokens, 16 new tokens (tok/s and ms
   a step printed); the phase's peak memory below 72 GiB;
7i. on phase 7's 4 prompts of 4,160 tokens, mixtral's ring decode
   against the kernel prefill at capacity factor E / k (no slot dropped,
   as in decode), teacher-forced over the last 64 positions (each writes
   over the ring's oldest slot), and the kernel route against the
   ``_swa`` route, teacher-forced: each layer's update within 1e-2
   relative L2 over the tokens that route alike on both sides, and the
   last logits where the last token does; the tokens routed otherwise
   (router near-ties that float order tips) at most 2% of them, each with
   a router margin below 1e-2; then the slots the served prefill (1.25)
   drops on those prompts and its logits' gap to the E / k prefill's;
9. time each kernel, its plain version and the matching PyTorch library
   call where one exists, at the main paths' shapes (the two scans' rows
   also give the bytes a call holds beyond its outputs and the mean time
   of each of their three launches from 7c and 7e; the two CenteredClip
   rows time the chain of 3 iterations the rounds run, an iteration's
   share against the chain's bound (x and v0 read once, the output
   written once), beside the chain's dependency floor (the stack read 4
   times), the single-iteration call against its own bound, ``x.clone()``
   of the stack as a reference rate, and the chain's three launch kinds
   from 6b and 4b); the median also at K = 7 kept rows (its bytes (K + 1)
   D * 4); krum_d2's library column the faster of ``torch.cdist(x, x) **
   2`` and the same with ``compute_mode="use_mm_for_euclid_dist"``, both
   timed; the attention kernel at its three served shapes (danube's and
   mixtral's bands against ``flex_attention`` with a sliding-window block
   mask, zamba2's causal triangle against
   ``scaled_dot_product_attention(is_causal=True)``) and at qwen3-moe's
   causal triangle at hd 128 (B 1, S 32,768, H 32 / 4; against SDPA
   ``is_causal`` with ``enable_gqa``; no driven path, so 0 launches; held
   against its plain version there first), each with the kernel its
   dispatcher takes.

Each driven path (phases 4, 4b, 4c, 4d, 4e, 4f, 5, 7, 7c, 7e, 7g, 7h, 10, 10b,
10c, 10d, 10e, 10f, 10g and 10h) has launch counters of its own:
zeroed just before it, read just after it, and held to the launches that
path must make (``EXPECTED_LAUNCHES``).

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line (all
nine kernels, the attention kernel four times: ``swa_attention`` at
danube's shape, ``swa_attention@zamba2``, ``swa_attention@mixtral`` and
``swa_attention@qwen3``), the
card's ``name, power.limit`` from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 10
D_FULL = 162_417_408            # protocol-125m's parameter count
SHOWCASE_ROUNDS = 3
CC_ITERS = 3                    # CenteredClip iterations a round (one chain)
BUCKET, LEVELS_WIRE = 512, 64   # compressed_wire's QSGD wire
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
# the serving path: h2o-danube-1.8b's prefill at the repo's prefill_32k length
SWA_SHAPE = dict(b=1, s=32_768, hq=32, hkv=8, hd=80, window=4096)
DANUBE_LAYERS = 24
SERVE_PREFILLS = 4              # served full swarm, one node offline, the true
                                # params and the coalition's: 24 launches each
# decode: the prompts overrun the 4,096-slot ring, which wraps 64 positions
# before they end; phase 7b steps WRAP_STEPS positions around the wrap,
# teacher-forced.  Phase 7's free-running decode steps only the first
# SERVE_DECODE_LEN tokens of them (decode is host-bound: each step costs the
# same whatever the position, so the cut saves ~3,770 of ~4,190 steps)
DECODE_PROMPTS, DECODE_LEN, DECODE_NEW = 4, SWA_SHAPE["window"] + 64, 32
WRAP_STEPS = 128
SERVE_DECODE_LEN = 392
# phase 7g: the continuous-batching engine on full-width danube through
# ``launch/serve.py --driver engine`` (16 requests of 64 tokens, 8 slots, 16
# new tokens), then a custody-gated run: protocol_serve's custody matrix,
# prompts of 32-64 tokens and budgets of 4-16 (numpy seed 11), one arrival a
# step, both holders of shard 0 down over steps [20, 40)
ENGINE_ARGS = dict(batch=16, slots=8, prompt_len=64, max_new=16)
ENGINE_CUSTODY = dict(n_nodes=8, num_shards=16, redundancy=2, max_fraction=0.35)
ENGINE_STEPS, ENGINE_OUTAGE = 200, (20, 40)
# layers 0 and 1 of each occupied slot's K/V at mid-horizon against the same
# request stepped alone (B = 1): bf16 rounding of two GEMM orders
ENGINE_KV_REL = 1e-2
# phase 10h: the reduced families' engines, card against CPU (the lane of
# tests/test_torch_serving_families.py)
ENGINE_FAMILIES = {"h2o-danube-1.8b": dict(sliding_window=8), "rwkv6-1.6b": {},
                   "zamba2-1.2b": {}, "mixtral-8x7b": {},
                   "qwen3-moe-30b-a3b": dict(num_experts=16, experts_per_token=8),
                   "qwen2-vl-2b": {}, "stablelm-3b": {}, "tinyllama-1.1b": {},
                   "granite-20b": {}}
# the rwkv6 serving path: rwkv6-1.6b's prefill at the same length
WKV_SHAPE = dict(b=1, s=32_768, h=32, k=64)
RWKV_LAYERS = 24
RWKV_PARAMS = 1_590_235_136     # the params built (param_count() says 1,929,480,192)
# 6 chunks and 8 tokens: not a multiple of the kernel's 64-token chunk (cut
# from 1,040 to keep the script's time with phases 4c, 10c and 10d added)
RWKV_DECODE_LEN = 392
# the zamba2 serving path: zamba2-1.2b's prefill at the same length
SSD_SHAPE = dict(b=1, s=32_768, h=64, p=64, n=64)
ZAMBA_LAYERS = 38               # Mamba2 layers: one ssd_scan launch each a prefill
ZAMBA_SHARED = 6                # applications of the shared attention block a prefill
# its attention: full causal, through the sliding-window kernel at window = S
CAUSAL_SHAPE = dict(b=1, s=32_768, hq=32, hkv=32, hd=64, window=32_768)
# phase 3's bound on the attention kernel's mean row relative L2 against its
# plain version in bf16, set between the kernel's reading and that of the
# plain version with p rounded to bf16 (the control, which must exceed it)
SWA_ROW_REL = 6e-4
ZAMBA_PARAMS = 1_170_157_696    # the params built (param_count() says 1,170,155,264)
ZAMBA_DECODE_LEN = 392          # as RWKV_DECODE_LEN
# the mixtral serving path (phase 7h): mixtral-8x7b at full width with its
# depth cut to 3 of 32 layers (the server holds ~12 bytes a parameter: 46.7B
# do not fit one card, 3 layers' 4,615,958,528 do), at the same length
MIXTRAL_LAYERS = 3
MIXTRAL_PARAMS = 4_615_958_528  # param_count() of the cut config, and the params built
MIXTRAL_SHAPE = dict(b=1, s=32_768, hq=32, hkv=8, hd=128, window=4096)
# qwen3-moe-30b-a3b's attention at the same length: full causal through the
# window kernel at window = S, hd 128 (phase 9 only: its prefill is not driven)
QWEN3_SHAPE = dict(b=1, s=32_768, hq=32, hkv=4, hd=128, window=32_768)
MIXTRAL_DECODE_LEN, MIXTRAL_DECODE_NEW = 392, 16
MIXTRAL_MEM_GIB = 72            # the phase's max_memory_allocated stays below this
# phase 7i: decode teacher-forced against the kernel prefill at capacity
# factor E / k over the last MIXTRAL_STEPS positions of phase 7's 4,160-token
# prompts (the ring wraps 64 positions before they end).  A token whose
# routing differs between the two sides (its k-th and (k+1)-th router
# probabilities a near tie that float order tips) is counted, not held:
# at most MOE_FLIP_FRAC of the stepped tokens, each with a router margin
# below MOE_FLIP_MARGIN; the others are held to 7b's 1e-2
MIXTRAL_STEPS = 64
MOE_FLIP_FRAC, MOE_FLIP_MARGIN = 0.02, 1e-2
# the §5.5 sweep: no_off_smoke (mean and CenteredClip at 2 and 6 attackers
# beside 6 honest nodes, one seed, and the honest baseline: 5 lanes of N =
# 12), its 2 CenteredClip lanes; 8 rounds on the tiny quadratic, cut to 2
# at protocol-125m's full width
NO_OFF_CC_LANES, NO_OFF_ROUNDS, NO_OFF_ROUNDS_125M = 2, 8, 2
NO_OFF_LOSS_REL = 1e-4          # card against CPU, finite final and baseline losses
# phase 4c: byzantine_neighborhood at full width (10 nodes on a degree-4
# random-regular graph, 2 sign-flip attackers, CenteredClip), 2 rounds; each
# node aggregates its neighbourhood: a median and a chain of 3 a node a round
DEC_ROUNDS = 2
DEC_HELD_CALL = N_NODES + 3     # node 3's aggregation in round 1, held against a lone call
FC_AGG_REL = 2e-3               # fully_connected == centralized (tests/test_topology.py:160)
# phase 10c: the no_off_lm grid of launch/derailment_no_off.py (3 regimes x
# 1, 4, 10 attackers beside 8 honest, and the baseline: 10 lanes of N = 18)
# on the small LM, its 30 rounds cut to 6 (the phase's time); each round of
# the card run from the CPU run's state: agg_norm within NO_OFF_LM_AGG_REL
# while the model has not blown up (an aggregate norm up to BLOWN_UP), final
# losses within NO_OFF_LM_LOSS_REL up to BLOWN_UP_LOSS (init 5.9); past
# those the lr-0.5 LM's float32 gradients are ill-conditioned, and both are
# held within NO_OFF_LM_BLOWN_REL (a blown-up final loss read 3.1e-4 apart)
# and finite on both sides or neither
NO_OFF_LM_ROUNDS, NO_OFF_LM_CC_LANES = 6, 3
NO_OFF_LM_AGG_REL, NO_OFF_LM_LOSS_REL, BLOWN_UP, BLOWN_UP_LOSS = 1e-3, 1e-4, 1e3, 1e2
NO_OFF_LM_BLOWN_REL = 2e-3
# phase 4d: the showcase with custody_leech's custody (16 shards, redundancy
# 2, no node over 40%, the last quarter of the roster the coalition)
CUSTODY = dict(num_shards=16, redundancy=2, max_fraction=0.4, coalition_fraction=0.25)
# phase 4e: stale_poisoning at full width (8 honest nodes, 2 sign-flip
# attackers that may lag 3 rounds, CenteredClip, audits at p 0.25, K = 3),
# 4 rounds, then 2 more timed
ASYNC_ROUNDS, ASYNC_BOUND = 4, 3
# phase 10e: no_off_async_smoke (CenteredClip at K = 0 and 2 against 2 and 6
# attackers beside 6 honest, the baselines: 6 lanes), its 4 CenteredClip lanes
NO_OFF_ASYNC_CC_LANES = 4
# phase 4f: economy_sybil_adaptive at full width, 3 rounds; an adaptive
# CenteredClip round aggregates once for each of the 4 scales it scores
# (economy.ADAPTIVE_SCALES) and once for itself; 2 more rounds timed
ECON_ROUNDS, ECON_SCORED = 3, 4
ECON_GAP_REL = 1e-4             # the conservation gap, of the inflow
ECON_AGG_REL = 1e-5             # a scored aggregate against the unfused one (phase 6's bound)
# phase 10g: no_off_economy_smoke, 4 fixed and 4 adaptive CenteredClip lanes
NO_OFF_ECON_CC_LANES = 4

# kernel -> (source, TPU kernel it replaces, the driven path that is its own[,
# the launch counter, where the row is the kernel at another path's shape])
KERNELS = {
    "masked_median": ("src/repro_torch/csrc/masked_agg.cu",
                      "src/repro/kernels/masked_agg/kernel.py:133", "showcase"),
    "masked_cc_iter": ("src/repro_torch/csrc/masked_agg.cu",
                       "src/repro/kernels/masked_agg/kernel.py:192", "showcase"),
    "masked_krum_d2": ("src/repro_torch/csrc/masked_agg.cu",
                       "src/repro/kernels/masked_agg/kernel.py:234", "krum"),
    "qsgd_decode_accumulate": ("src/repro_torch/csrc/qsgd_decode.cu",
                               "src/repro/kernels/qsgd_decode/kernel.py:41",
                               "compressed_wire"),
    "qsgd_encode": ("src/repro_torch/csrc/qsgd_encode.cu",
                    "src/repro/kernels/qsgd/kernel.py:41", "showcase"),
    "cc_iter": ("src/repro_torch/csrc/centered_clip.cu",
                "src/repro/kernels/centered_clip/kernel.py:48", "showcase_sequential"),
    "swa_attention": ("src/repro_torch/csrc/swa_attention.cu",
                      "src/repro/kernels/swa_attention/kernel.py:65", "protocol_serve"),
    "swa_attention@zamba2": ("src/repro_torch/csrc/swa_attention.cu",
                             "src/repro/kernels/swa_attention/kernel.py:65",
                             "protocol_serve_zamba2", "swa_attention"),
    "swa_attention@mixtral": ("src/repro_torch/csrc/swa_attention.cu",
                              "src/repro/kernels/swa_attention/kernel.py:65",
                              "protocol_serve_mixtral", "swa_attention"),
    # no driven path: its launches are 0
    "swa_attention@qwen3": ("src/repro_torch/csrc/swa_attention.cu",
                            "src/repro/kernels/swa_attention/kernel.py:65",
                            None, "swa_attention"),
    "wkv_scan": ("src/repro_torch/csrc/rwkv6_wkv.cu",
                 "src/repro/kernels/rwkv6_wkv/kernel.py:73", "protocol_serve_rwkv6"),
    "ssd_scan": ("src/repro_torch/csrc/mamba2_ssd.cu",
                 "src/repro/kernels/mamba2_scan/kernel.py:71", "protocol_serve_zamba2"),
}

# one fused CenteredClip round (sign_flip_minority's): a median, 3 iterations
_CC_ROUND = {"masked_median": 1, "masked_cc_iter": CC_ITERS}
# launches each driven path must make (kernels not named: none).  A
# CenteredClip round warm-starts from one median and runs 3 iterations; a
# fused qsgd round encodes each node's row once.
EXPECTED_LAUNCHES = {
    "showcase": {"masked_median": SHOWCASE_ROUNDS,
                 "masked_cc_iter": 3 * SHOWCASE_ROUNDS,
                 "qsgd_encode": N_NODES * SHOWCASE_ROUNDS},
    # the showcase with a custody lane: the same launches (custody only observes)
    "showcase_custody": {"masked_median": SHOWCASE_ROUNDS,
                         "masked_cc_iter": 3 * SHOWCASE_ROUNDS,
                         "qsgd_encode": N_NODES * SHOWCASE_ROUNDS},
    # the async round takes the fused median and chain as the synchronous one
    "stale_poisoning": {k: ASYNC_ROUNDS * v for k, v in _CC_ROUND.items()},
    "no_off_async_smoke": {k: NO_OFF_ASYNC_CC_LANES * NO_OFF_ROUNDS * v
                           for k, v in _CC_ROUND.items()},
    # the economy lane: the round's CenteredClip and the 4 scored ones
    "economy_sybil_adaptive": {k: ECON_ROUNDS * (1 + ECON_SCORED) * v
                               for k, v in _CC_ROUND.items()},
    # no_off_economy_smoke: a fixed CenteredClip lane one a round, an
    # adaptive one 5; mean lanes score and aggregate without a kernel
    "no_off_economy_smoke": {k: NO_OFF_ROUNDS * NO_OFF_ECON_CC_LANES * (1 + (1 + ECON_SCORED)) * v
                             for k, v in _CC_ROUND.items()},
    # custody_smoke's lanes are all mean over an uncompressed wire: no kernel
    "custody_smoke": {},
    "showcase_sequential": {"masked_median": SHOWCASE_ROUNDS,
                            "cc_iter": 3 * SHOWCASE_ROUNDS},
    "krum": {"masked_krum_d2": 1},
    "compressed_wire": {"qsgd_decode_accumulate": 1, "qsgd_encode": N_NODES},
    "sign_flip_minority": _CC_ROUND,
    # the no_off_smoke sweep: its 2 CenteredClip lanes take a sign_flip_minority
    # round's launches each round; mean lanes and the baseline launch none
    "no_off_smoke": {k: NO_OFF_CC_LANES * NO_OFF_ROUNDS * v
                     for k, v in _CC_ROUND.items()},
    # at full width, 2 rounds: the sweep's 2 CenteredClip lanes, then the
    # CenteredClip cell's single-run Swarm (the mean cell's launches none)
    "no_off_smoke_125m": {k: (NO_OFF_CC_LANES + 1) * NO_OFF_ROUNDS_125M * v
                          for k, v in _CC_ROUND.items()},
    # the decentralized round at full width: each node's neighbourhood
    "byzantine_neighborhood": {k: N_NODES * DEC_ROUNDS * v for k, v in _CC_ROUND.items()},
    # the small LM's no_off_lm sweep: its 3 CenteredClip lanes, each round
    "no_off_lm": {k: NO_OFF_LM_CC_LANES * NO_OFF_LM_ROUNDS * v for k, v in _CC_ROUND.items()},
    # no_off_topology_smoke's entry is set by phase 10d from its graphs (one
    # CenteredClip round for each node with a kept neighbour: 368 a sweep)
    "protocol_serve": {"swa_attention": DANUBE_LAYERS * SERVE_PREFILLS},
    # the serving engine prefills by stepping decode_step, which runs no kernel
    "serving_engine": {},
    "serving_smoke": {},
    "protocol_serve_rwkv6": {"wkv_scan": RWKV_LAYERS * SERVE_PREFILLS},
    "protocol_serve_zamba2": {"ssd_scan": ZAMBA_LAYERS * SERVE_PREFILLS,
                              "swa_attention": ZAMBA_SHARED * SERVE_PREFILLS},
    # mixtral's MoE is torch ops; its window runs the attention kernel
    "protocol_serve_mixtral": {"swa_attention": MIXTRAL_LAYERS * SERVE_PREFILLS},
}


def self_dev(e):
    """A profiler event's own device ms."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0) / 1e3


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'}: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, build)
    try:
        smoke.run()
    except Exception:                       # any failed phase: no result line
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(smoke.tmp, ignore_errors=True)
    return 0


class Smoke:
    def __init__(self, torch, build):
        self.torch = torch
        self.build = build
        self.dev = torch.device("cuda")
        self.errors = {}           # kernel -> max abs error at main-path shapes
        self.row_errors = {}       # kernel -> mean row relative L2, where phase 3 reads one
        self.launches = {}         # driven path -> {kernel: launches on it}
        self.scan_split = {}       # kernel -> {its launch kind: mean ms a launch}
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_")   # the custody checkpoints

    # -- helpers ------------------------------------------------------------------
    def phase(self, name, fn):
        torch = self.torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.time()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        print(f"[phase] {name}: ok, {start.elapsed_time(end) / 1e3:.3f} s on CUDA "
              f"events ({time.time() - t0:.3f} s wall)", flush=True)
        return out

    def free(self):
        import gc
        gc.collect()
        self.torch.cuda.empty_cache()

    def stack(self, n, d, seed):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        x = self.torch.randn((n, d), generator=g, device=self.dev)
        return x.mul_(2.0).add_(0.5)

    def mask(self, n, kind):
        torch = self.torch
        i = torch.arange(n, device=self.dev)
        return {"all": i < n, "k1": i == min(2, n - 1), "even": i < 2 * max(1, n // 3),
                "none": i < 0}[kind]

    def bit_equal(self, a, b):
        """Identical bit patterns (signed zeros included); NaN matches NaN."""
        same = a.view(self.torch.int32) == b.view(self.torch.int32)
        return bool((same | (a.isnan() & b.isnan())).all())

    def record_err(self, name, a, b):
        diff = (a - b).abs()
        diff = diff[~(a.isnan() & b.isnan())]
        err = float(diff.max()) if diff.numel() else 0.0
        self.errors[name] = max(self.errors.get(name, 0.0), err)
        return err

    def ckpt_args(self, name):
        """The launcher's ``--ckpt`` into this run's temporary directory."""
        return ["--ckpt", str(Path(self.tmp) / name)]

    def counted(self, path, fn):
        """Run ``fn`` with every launch counter at 0 and hold the counts
        just after it to ``EXPECTED_LAUNCHES[path]``."""
        from repro_torch.kernels.centered_clip import ops as cc
        from repro_torch.kernels.mamba2_scan import ops as ssd
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.kernels.qsgd import ops as qenc
        from repro_torch.kernels.qsgd_decode import ops as qdec
        from repro_torch.kernels.rwkv6_wkv import ops as wkv
        from repro_torch.kernels.swa_attention import ops as swa
        counters = (magg.LAUNCHES, qdec.LAUNCHES, qenc.LAUNCHES, cc.LAUNCHES, swa.LAUNCHES,
                    wkv.LAUNCHES, ssd.LAUNCHES)
        for d in counters:
            for k in d:
                d[k] = 0
        out = fn()
        got = {k: n for d in counters for k, n in d.items()}
        want = {k: EXPECTED_LAUNCHES[path].get(k, 0) for k in got}
        print(f"  launches on {path}: {json.dumps(got)}", flush=True)
        check(got == want, f"{path}: launches {got}, expected {want}")
        self.launches[path] = got
        return out

    # -- phases -------------------------------------------------------------------
    def run(self):
        torch = self.torch
        self.phase("1 build kernels", self.build_kernels)
        self.phase("2 swarm kernels vs plain", self.kernels_vs_plain)
        self.phase("2b qsgd_encode and cc_iter vs plain", self.encode_and_cc_vs_plain)
        self.phase("3 swa_attention vs plain", self.swa_vs_plain)
        self.phase("3b wkv_scan vs plain", self.wkv_vs_plain)
        self.phase("3c ssd_scan vs plain", self.ssd_vs_plain)
        torch.cuda.reset_peak_memory_stats()
        main_out = self.phase("4 main path (showcase, full width)", self.main_path)
        self.phase("4d custody lane (showcase with custody_leech's custody, full width)",
                   lambda: self.custody_lane(main_out))
        self.free()
        self.phase("5 other configs (full width)", lambda: self.other_configs(main_out))
        self.phase("6 fused vs unfused", lambda: self.fused_vs_unfused(main_out))
        self.phase("6b showcase rounds timed and profiled",
                   lambda: self.profile_rounds(main_out["swarm"], "masked_cc_iter"))
        seq_out = self.phase("4b sequential engine (showcase_sequential, full width)",
                             self.sequential_path)
        del seq_out
        self.free()
        self.phase("6c sequential vs batched engine, round 0 (full width)",
                   lambda: self.engines_agree(main_out))
        main_out.pop("swarm")
        self.free()
        torch.cuda.reset_peak_memory_stats()
        self.phase("4c decentralized round (byzantine_neighborhood, full width)",
                   self.decentralized_path)
        self.free()
        torch.cuda.reset_peak_memory_stats()
        self.phase("4e async round (stale_poisoning, full width)", self.async_path)
        self.free()
        torch.cuda.reset_peak_memory_stats()
        self.phase("4f economy lane (economy_sybil_adaptive, full width)", self.economy_path)
        self.free()
        self.phase("10 no_off_smoke on the tiny quadratic, card vs CPU", self.no_off_smoke)
        self.phase("10c no_off_lm on the small LM, card vs CPU", self.no_off_lm)
        self.phase("10d no_off_topology_smoke on the tiny quadratic, card vs CPU",
                   self.no_off_topology)
        self.phase("10e no_off_async_smoke on the tiny quadratic, card vs CPU",
                   self.no_off_async)
        self.phase("10f custody_smoke on the tiny quadratic, card vs CPU", self.custody_smoke)
        self.phase("10g no_off_economy_smoke on the tiny quadratic, card vs CPU",
                   self.no_off_economy)
        self.phase("10h serving_smoke and the reduced families' engines, card vs CPU",
                   self.serving_smoke)
        torch.cuda.reset_peak_memory_stats()
        self.phase("10b no_off_smoke campaign on protocol-125m (full width)",
                   lambda: self.campaign_full_width(main_out["problem"]))
        del main_out
        self.free()
        torch.cuda.reset_peak_memory_stats()
        serve_out = self.phase("7 serving path (protocol_serve, h2o-danube-1.8b full width)",
                               self.protocol_serve)
        self.phase("7b ring decode vs kernel prefill across the wrap (full width)",
                   lambda: self.decode_vs_prefill(serve_out))
        self.phase("8 kernel route vs _swa route (full width)",
                   lambda: self.swa_route_gap(serve_out))
        del serve_out
        self.free()
        torch.cuda.reset_peak_memory_stats()
        self.phase("7g serving engine (launch/serve.py --driver engine, h2o-danube-1.8b "
                   "full width)", self.serving_engine)
        self.free()
        torch.cuda.reset_peak_memory_stats()
        rwkv_out = self.phase("7c serving path (protocol_serve_rwkv6, rwkv6-1.6b full width)",
                              self.protocol_serve_rwkv6)
        self.phase("7d decode vs kernel prefill, float32 copy (rwkv6 full width)",
                   lambda: self.rwkv_decode_vs_prefill(rwkv_out))
        self.phase("8b kernel route vs wkv_chunked route (rwkv6 full width)",
                   lambda: self.wkv_route_gap(rwkv_out))
        del rwkv_out
        self.free()
        torch.cuda.reset_peak_memory_stats()
        zamba_out = self.phase("7e serving path (protocol_serve_zamba2, zamba2-1.2b full width)",
                               self.protocol_serve_zamba2)
        self.phase("7f decode vs kernel prefill, float32 copy (zamba2 full width)",
                   lambda: self.zamba_decode_vs_prefill(zamba_out))
        self.phase("8c kernel route vs ssd_chunked route (zamba2 full width)",
                   lambda: self.ssd_route_gap(zamba_out))
        self.phase("8d kernel route vs blockwise route (zamba2 full width)",
                   lambda: self.causal_route_gap(zamba_out))
        del zamba_out
        self.free()
        torch.cuda.reset_peak_memory_stats()
        mixtral_out = self.phase("7h serving path (protocol_serve_mixtral, mixtral-8x7b full "
                                 "width, 3 layers)", self.protocol_serve_mixtral)
        self.phase("7i decode vs kernel prefill at capacity factor E / k, kernel route vs "
                   "_swa route (mixtral full width)",
                   lambda: self.mixtral_decode_vs_prefill(mixtral_out))
        del mixtral_out
        self.free()
        rows = self.phase("9 timings", self.timings)
        print(json.dumps({"kernels": rows}), flush=True)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
              else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)

    def build_kernels(self):
        """Build every kernel; print ptxas's registers and spills of each
        entry function and its warnings.  Fails if the attention kernel's
        hd-128 instantiation spills."""
        logs = self.build.build()
        spills = {}                # entry function -> (spill stores, spill loads)
        for lib, log in logs.items():
            fn, frame = None, ""
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    fn, frame = line.split("'")[1], ""
                elif "bytes stack frame" in line and fn is not None:
                    frame = line.strip()
                    found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", frame)
                    spills[fn] = tuple(map(int, found.groups())) if found else None
                elif "Used" in line and fn is not None:
                    print(f"  ptxas {lib}: {fn[-60:]} {line.split(':', 1)[1].strip()}; {frame}")
                    fn = None
                elif "warning" in line.lower():
                    print(f"  ptxas {lib}: {line.strip()}")
        if "swa_attention" in logs:
            hd128 = {f: v for f, v in spills.items() if "swa_fwd_bf16_wgmmaILi128E" in f}
            check(len(hd128) == 1, f"ptxas reported no hd-128 attention kernel ({list(spills)})")
            check(list(hd128.values()) == [(0, 0)],
                  f"the hd-128 attention kernel spills: {hd128}")
            print(f"  swa_attention hd 128: spill stores and loads {list(hd128.values())[0]}")
        else:
            print("  swa_attention was built before this run: no ptxas report")
        for name in self.build.SOURCES:
            self.build.load(name)

    def kernels_vs_plain(self):
        torch = self.torch
        from repro_torch.core.aggregation import _krum_scores_from_d2
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.kernels.qsgd_decode import ops as qdec
        cases = [(N_NODES, D_FULL, True), (3, 1_000_003, False)]
        for n, d, main_shape in cases:
            x = self.stack(n, d, seed=n)
            for kind in ("all", "k1", "even", "none"):
                m = self.mask(n, kind)
                tag = f"N={n} D={d} mask={kind}"
                # median: bit-equal, NaN where no row is kept
                out, ref = magg.masked_median(x, m), magg.masked_median_plain(x, m)
                check(self.bit_equal(out, ref), f"median not bit-equal ({tag})")
                if main_shape:
                    self.record_err("masked_median", out, ref)
                # CenteredClip iteration, fixed and adaptive tau, from the median
                v = torch.nan_to_num(out)
                for tau in (2.0, None):
                    o = magg.masked_cc_iter(x, v, m, clip_tau=tau)
                    r = magg.masked_cc_iter_plain(x, v, m, tau)
                    both_nan = o.isnan() & r.isnan()
                    ok = ((o - r).abs() <= 3e-5 + 3e-5 * r.abs()) | both_nan
                    check(bool(ok.all()), f"cc_iter beyond 3e-5 ({tag}, tau={tau})")
                    if main_shape:
                        self.record_err("masked_cc_iter", o, r)
                    del o, r
                    if main_shape:
                        self.chain_vs_iters(
                            lambda vv, t=tau: magg.masked_cc_iter(x, vv, m, clip_tau=t),
                            lambda vv, t=tau: magg.masked_cc_iter_plain(x, vv, m, t),
                            lambda vv, t=tau: magg.masked_cc_chain(x, vv, m, iters=CC_ITERS,
                                                                   clip_tau=t),
                            v, f"masked_cc_chain ({tag}, tau={tau})", "masked_cc_iter")
                del out, ref, v
                print(f"  median + cc_iter ok: {tag}", flush=True)
            if main_shape:
                self.median_every_k(x)
                self.graph_replay(x)
            # krum d2: gram-form rounding, same selection on every mask.  The
            # gram form cancels: d2 = |x_i|^2 + |x_j|^2 - 2 x_i.x_j, so float32
            # rounding scales with the squared norms, sums of D products
            # (~1e-6 of them at D = 1.6e8).  Held against the plain version
            # (which sums each thread's columns, then the threads and blocks,
            # as the kernel does) and against an independent float64 gram,
            # each within 1e-5 of the squared norms
            d2, ref = magg.masked_krum_d2(x), magg.masked_krum_d2_plain(x)
            g64 = torch.zeros((n, n), dtype=torch.float64, device=self.dev)
            step = (1 << 24) // n
            for c0 in range(0, d, step):
                xc = x[:, c0:c0 + step].double()
                g64 += xc @ xc.T
            del xc
            q = torch.diagonal(g64)
            d64 = q[:, None] + q[None, :] - 2.0 * g64
            scale = q[:, None] + q[None, :]
            for who, val in (("plain", ref.double()), ("float64", d64)):
                rel = float(((d2.double() - val).abs() / scale).max())
                print(f"  krum_d2: max |d2 - {who}| / (|x_i|^2 + |x_j|^2) = "
                      f"{rel:.3e}", flush=True)
                check(rel <= 1e-5, f"krum d2 beyond 1e-5 of the squared norms "
                                   f"from {who} (N={n})")
            del g64, d64
            for kind in ("all", "k1", "even"):
                m = self.mask(n, kind)
                for f in (1, 2):
                    a = int(torch.argmin(_krum_scores_from_d2(d2, m, f)))
                    b = int(torch.argmin(_krum_scores_from_d2(ref, m, f)))
                    check(a == b, f"krum selection differs (N={n}, mask={kind}, f={f})")
            if main_shape:
                self.record_err("masked_krum_d2", d2, ref)
            print(f"  krum_d2 ok: N={n} D={d}", flush=True)
            # decode-accumulate on compressed_wire's 64-level wire of x's rows
            # and on a 127-level one (1/127 is not a power of two, so the
            # kernel's float32 1/levels is inexact), bit-equal to the plain
            # version
            nb = -(-d // BUCKET)
            wires = {}
            g = torch.Generator(device=self.dev).manual_seed(7)
            for levels in (LEVELS_WIRE, 127):
                codes = torch.empty((n, nb * BUCKET), dtype=torch.int8, device=self.dev)
                norms = torch.empty((n, nb), dtype=torch.float32, device=self.dev)
                for i in range(n):
                    u = torch.rand((nb, BUCKET), generator=g, device=self.dev)
                    p = qdec.wire_encode(x[i], u, levels=levels, bucket_size=BUCKET)
                    codes[i], norms[i] = p.codes.reshape(-1), p.norms.reshape(-1)
                    del u, p
                wires[levels] = codes, norms
            del x
            self.free()
            for levels, (codes, norms) in wires.items():
                for kind in ("all", "k1", "none"):
                    w = self.mask(n, kind).float()
                    o = qdec.decode_accumulate_kernel(codes, norms, w, levels=levels,
                                                      bucket_size=BUCKET)
                    r = qdec.decode_accumulate_plain(codes, norms, w, levels=levels,
                                                     bucket_size=BUCKET)
                    check(self.bit_equal(o, r),
                          f"decode not bit-equal (N={n}, levels={levels}, mask={kind})")
                    if main_shape:
                        self.record_err("qsgd_decode_accumulate", o, r)
                    del o, r
                print(f"  decode_accumulate bit-equal: N={n} L={nb * BUCKET} levels={levels}",
                      flush=True)
            del codes, norms, wires
            self.free()

    def median_every_k(self, x):
        """The median at every kept count K = 0..N at full width, the kept
        rows a random subset, bit-equal to its plain version: each K takes
        its own branch of the kernel (K = 0 NaN, the exact networks up to
        16)."""
        torch = self.torch
        from repro_torch.kernels.masked_agg import ops as magg
        n = x.shape[0]
        g = torch.Generator().manual_seed(5)
        for k in range(n + 1):
            m = torch.zeros(n, dtype=torch.bool)
            m[torch.randperm(n, generator=g)[:k]] = True
            m = m.to(self.dev)
            out, ref = magg.masked_median(x, m), magg.masked_median_plain(x, m)
            check(self.bit_equal(out, ref), f"median not bit-equal at K={k} (full width)")
            self.record_err("masked_median", out, ref)
            del out, ref
        print(f"  median bit-equal at every K = 0..{n} (N={n} D={x.shape[1]})", flush=True)

    def graph_replay(self, x):
        """masked_median and masked_krum_d2 captured once in a CUDA graph
        and replayed: equal to eager calls at the captured mask and after
        other masks are copied into its buffer, so neither wrapper reads
        the mask or K on the host."""
        torch = self.torch
        from repro_torch.kernels.masked_agg import ops as magg
        n = x.shape[0]
        mask = torch.ones(n, dtype=torch.bool, device=self.dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            med = magg.masked_median(x, mask)
            d2 = magg.masked_krum_d2(x)
        for keep in (n, 7, 0, 4):
            mask.copy_(torch.arange(n, device=self.dev) < keep)
            graph.replay()
            torch.cuda.synchronize()
            check(self.bit_equal(med, magg.masked_median(x, mask)),
                  f"median under graph replay differs from eager (K={keep})")
            check(torch.equal(d2, magg.masked_krum_d2(x)),
                  f"krum_d2 under graph replay differs from eager (K={keep})")
        del graph, med, d2
        print("  median and krum_d2 replayed in a CUDA graph at K = 10, 7, 0, 4: equal to "
              "eager", flush=True)

    def swa_inputs(self, b, s, hq, hkv, hd, dtype, seed=0):
        g = self.torch.Generator(device=self.dev).manual_seed(seed)
        return tuple(self.torch.randn(shape, generator=g, device=self.dev).to(dtype)
                     for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))

    def swa_vs_plain(self):
        torch = self.torch
        from repro_torch.kernels.swa_attention import ops as swa
        main, causal = tuple(SWA_SHAPE.values()), tuple(CAUSAL_SHAPE.values())
        mixtral = tuple(MIXTRAL_SHAPE.values())
        cases = [(main, torch.bfloat16), (causal, torch.bfloat16)] + [
            (shape, dt) for shape in (
                mixtral,                      # mixtral's band, hd 128
                (1, 4099, 32, 4, 128, 4099),  # qwen3's causal triangle at hd 128
                (1, 4099, 48, 1, 128, 4099),  # granite's MQA, window = S
                (2, 1000, 8, 2, 128, 300),    # hd 128, a band both tile edges cut, B 2
                (2, 100, 4, 2, 128, 4096))    # hd 128 below one 128-query tile
            for dt in (torch.bfloat16, torch.float32)] + [
            (shape, dt) for shape in (
                (2, 1000, 8, 2, 64, 17),      # S not a multiple of 64, window < a tile
                (1, 4099, 16, 4, 80, 1000),   # window not a multiple of a tile
                (2, 777, 4, 4, 128, 4096),    # window >= S
                (1, 2000, 8, 1, 128, 64),     # window == one tile, G = 8
                (2, 1000, 8, 8, 64, 1000),    # window == S, MHA, B 2
                (1, 4099, 16, 16, 64, 4099),  # window == S, ragged past a 128 tile
                (1, 3001, 16, 4, 80, 5000),   # window > S, GQA, hd 80
                (2, 100, 4, 2, 80, 4096))     # S below one 128-query tile
            for dt in (torch.float32, torch.bfloat16)]
        for (b, s, hq, hkv, hd, window), dt in cases:
            q, k, v = self.swa_inputs(b, s, hq, hkv, hd, dt)
            path = swa.kernel_path(s, hd, dt)
            wgmma = dt == torch.bfloat16 and hd in (64, 80, 128) and s >= 128
            check(path == swa.PATHS[2 if wgmma else 0 if dt == torch.float32 else 1],
                  f"swa_attention: B={b} S={s} hd={hd} {dt} took the path {path}")
            out = swa.swa_attention_kernel(q, k, v, window=window)
            again = swa.swa_attention_kernel(q, k, v, window=window)
            ref = swa.swa_attention_plain(q, k, v, window=window)
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            tag = f"B={b} S={s} H={hq}/{hkv} hd={hd} W={window} {dt}"
            check(torch.equal(out.view(bits), again.view(bits)),
                  f"swa_attention: two launches differ ({tag})")
            tol = 2e-2 if dt == torch.bfloat16 else 2e-4
            o, r = out.float(), ref.float()
            err = float((o - r).abs().max())
            check(bool(torch.isfinite(o).all()) and bool(
                ((o - r).abs() <= tol + tol * r.abs()).all()),
                f"swa_attention beyond {tol} of its plain version ({tag}): {err:.3e}")
            rel = self.row_rel(o, r)
            note = f"row rel L2 {rel:.3e}"
            if dt == torch.bfloat16:
                # the elementwise bound cannot tell a bf16 p from the fp32 p
                # of the hi/lo split; the mean row error can, and the control
                # (the plain version with p rounded to bf16) shows it here
                control = self.row_rel(self.swa_plain_bf16_p(q, k, v, window), r)
                note += f" (bf16-p control {control:.3e}, limit {SWA_ROW_REL:.0e})"
                check(control > SWA_ROW_REL,
                      f"swa_attention: the bf16-p control is within {SWA_ROW_REL:.0e} "
                      f"of plain ({tag}: {control:.3e}), so the check cannot see it")
                check(rel <= SWA_ROW_REL, f"swa_attention beyond {SWA_ROW_REL:.0e} mean row "
                      f"relative L2 of its plain version ({tag}): {rel:.3e}")
            for name, shape in (("swa_attention", main), ("swa_attention@zamba2", causal),
                                ("swa_attention@mixtral", mixtral)):
                if (b, s, hq, hkv, hd, window) == shape and dt == torch.bfloat16:
                    self.record_err(name, o, r)
                    self.row_errors[name] = rel
            print(f"  swa_attention ok: {tag}, path {path}, max abs err {err:.3e}, {note}",
                  flush=True)
            del q, k, v, out, again, ref, o, r
        self.free()

    def row_rel(self, a, b):
        """The mean over (batch, position, head) rows of |a - b| / |b|, L2
        over the head dim: each row weighs alike, where a global norm is
        half made of the first tile's few large rows."""
        a, b = a.float(), b.float()
        return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp(min=1e-30)).mean())

    def swa_plain_bf16_p(self, q, k, v, window, block_q=512):
        """The control of phase 3: ``swa_attention_plain`` with p rounded to
        bf16 before p.v, what the kernel would compute without the lo half
        of its p."""
        torch = self.torch
        b, s, hq, hd = q.shape
        hkv = k.shape[2]
        out = torch.empty_like(q)
        for q0 in range(0, s, block_q):
            q1 = min(s, q0 + block_q)
            k0 = max(0, q0 - window + 1)
            qg = q[:, q0:q1].reshape(b, q1 - q0, hkv, hq // hkv, hd).float()
            sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k[:, k0:q1].float()) * hd ** -0.5
            qpos = torch.arange(q0, q1, device=q.device)[:, None]
            kpos = torch.arange(k0, q1, device=q.device)[None, :]
            sc = sc.masked_fill((kpos > qpos) | (qpos - kpos >= window), -1e30)
            p = torch.softmax(sc, dim=-1).bfloat16().float()
            o = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, k0:q1].float())
            out[:, q0:q1] = o.reshape(b, q1 - q0, hq, hd).to(q.dtype)
        return out

    def wkv_inputs(self, b, s, h, k, dtype, decay="model", seed=0):
        """r, k, v, w (B, S, H, K) in ``dtype`` and u (H, K) float32.  w as
        the model's init draws it (exp(-exp(-6 + lora)), near 0.9975), or
        ``strong``: uniform in [0.05, 0.95], where the TPU kernel's form
        overflows."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        shape = (b, s, h, k)
        r, kk = (torch.randn(shape, generator=g, device=self.dev) * 0.5 for _ in range(2))
        v = torch.randn(shape, generator=g, device=self.dev)
        if decay == "strong":
            w = 0.05 + 0.9 * torch.rand(shape, generator=g, device=self.dev)
        else:
            w = torch.exp(-torch.exp(-6.0 + torch.randn(shape, generator=g, device=self.dev)))
        u = torch.randn((h, k), generator=g, device=self.dev) * 0.1
        return [t.to(dtype) for t in (r, kk, v, w)] + [u]

    def wkv_vs_plain(self):
        torch = self.torch
        from repro_torch.kernels.rwkv6_wkv import ops
        main = tuple(WKV_SHAPE.values())
        cases = [(main, torch.bfloat16, "model", False)] + [
            (shape, dt, decay, s0) for shape, decay, s0 in (
                ((1, 1, 4, 64), "model", True),          # one token
                ((2, 1000, 4, 32), "model", False),      # S not a multiple of the chunk
                ((1, 4099, 8, 128), "model", True),
                ((1, 777, 4, 64), "strong", True),       # the TPU form overflows here
                ((2, 300, 2, 16), "strong", False),
                ((2, 63, 4, 64), "model", True),         # the chunk's boundaries
                ((1, 64, 4, 64), "strong", True),
                ((1, 65, 4, 32), "model", False),
                ((1, 197, 4, 64), "strong", True))
            for dt in (torch.float32, torch.bfloat16)]
        for (b, s, h, k), dt, decay, with_s0 in cases:
            args = self.wkv_inputs(b, s, h, k, dt, decay)
            s0 = None
            if with_s0:
                g = torch.Generator(device=self.dev).manual_seed(1)
                s0 = torch.randn((b, h, k, k), generator=g, device=self.dev)
            y, sf = ops.wkv_kernel(*args, s0)
            y2, sf2 = ops.wkv_kernel(*args, s0)
            ry, rs = ops.wkv_plain(*args, s0)
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            tag = f"B={b} S={s} H={h} K={k} {dt} decay={decay} s0={with_s0}"
            check(torch.equal(y.view(bits), y2.view(bits)) and torch.equal(sf, sf2),
                  f"wkv_scan: two launches differ ({tag})")
            tol = ops.BF16_REL if dt == torch.bfloat16 else 1e-4
            ey, es = self.rel(y, ry), self.rel(sf, rs)
            check(bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(sf).all())
                  and ey <= tol and es <= 1e-4,
                  f"wkv_scan beyond its plain version ({tag}): y {ey:.3e} (bound {tol}), "
                  f"s_final {es:.3e} (bound 1e-4)")
            note = ""
            if dt == torch.bfloat16:
                control = self.rel(ops.wkv_plain(*args, s0, bf16_operands=True)[0], ry)
                note = f" (bf16-operand control {control:.3e}, bound {tol:.0e})"
                if (b, s, h, k) == main or decay == "strong":
                    check(control > tol, f"wkv_scan: the bf16-operand control is within "
                          f"{tol:.0e} of plain ({tag}: {control:.3e}), so the check cannot see it")
            if ((b, s, h, k), dt) == (main, torch.bfloat16):
                self.record_err("wkv_scan", y.float(), ry.float())
            print(f"  wkv_scan ok: {tag}, y rel L2 {ey:.3e}{note}, s_final rel L2 {es:.3e}",
                  flush=True)
            del args, y, y2, ry, sf, sf2, rs
        self.free()

    def ssd_inputs(self, b, s, h, p, n, dtype, decay="model", seed=0):
        """x, dt, a, b, c, d_skip: x, b, c in ``dtype``, the rest float32.
        ``model``: Δ and a as the model's init gives them (dt_bias in [-4,
        -2), a_log 0: Δ about 0.05, a = -1, drawn here as softplus(N - 3)
        and -exp(N / 2)); ``strong``: Δ near 4 and a near -8, so a·Δ sums to
        about -1,000 over a 32-token chunk."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        shift, scale = (4.0, 8.0) if decay == "strong" else (-3.0, 1.0)
        x = torch.randn((b, s, h, p), generator=g, device=self.dev)
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, h), generator=g, device=self.dev) + shift)
        a = -torch.exp(torch.randn((h,), generator=g, device=self.dev) * 0.5) * scale
        bb, cc = (torch.randn((b, s, n), generator=g, device=self.dev) * 0.5 for _ in range(2))
        d = torch.rand((h,), generator=g, device=self.dev)
        return [x.to(dtype), dt, a, bb.to(dtype), cc.to(dtype), d]

    def ssd_vs_plain(self):
        torch = self.torch
        from repro_torch.kernels.mamba2_scan import ops
        main = tuple(SSD_SHAPE.values())
        cases = [(main, torch.bfloat16, "model", False)] + [
            (shape, dt, decay, h0) for shape, decay, h0 in (
                ((1, 1, 4, 64, 64), "model", True),        # one token
                ((2, 1040, 4, 64, 64), "model", True),     # 16 chunks and 16 tokens
                ((1, 997, 3, 32, 16), "strong", True),     # a prime S, strong decay
                ((1, 300, 2, 48, 128), "model", False),
                ((2, 77, 2, 16, 48), "strong", False),
                # the chunk's boundaries; 9 heads: a ragged head group; P 80: two slices
                ((2, 63, 9, 64, 64), "model", True),
                ((1, 64, 16, 64, 64), "strong", True),
                ((1, 65, 3, 80, 48), "model", False),
                ((1, 197, 8, 64, 64), "strong", True))
            for dt in (torch.float32, torch.bfloat16)]
        for (b, s, h, p, n), dt, decay, with_h0 in cases:
            args = self.ssd_inputs(b, s, h, p, n, dt, decay)
            h0 = None
            if with_h0:
                g = torch.Generator(device=self.dev).manual_seed(1)
                h0 = torch.randn((b, h, p, n), generator=g, device=self.dev)
            y, hf = ops.ssd_kernel(*args, h0)
            y2, hf2 = ops.ssd_kernel(*args, h0)
            ry, rh = ops.ssd_plain(*args, h0)
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            tag = f"B={b} S={s} H={h} P={p} N={n} {dt} decay={decay} h0={with_h0}"
            check(torch.equal(y.view(bits), y2.view(bits)) and torch.equal(hf, hf2),
                  f"ssd_scan: two launches differ ({tag})")
            ey, eh = self.rel(y, ry), self.rel(hf, rh)
            yf, rf = y.float(), ry.float()
            ok = bool(torch.isfinite(yf).all()) and bool(torch.isfinite(hf).all())
            note = ""
            if dt == torch.bfloat16:
                # one bf16 rounding of y: an ulp is at most 2^-7 of |y|; the
                # floor covers float32 differences of values near zero
                ulp = 2.0 ** -7 * rf.abs() + 1e-5 * float(rf.abs().max())
                ok = ok and bool(((yf - rf).abs() <= ulp).all()) and ey <= ops.BF16_REL
                control = self.rel(ops.ssd_plain(*args, h0, bf16_operands=True)[0], ry)
                note = f" (bf16-operand control {control:.3e}, bound {ops.BF16_REL:.0e})"
                if (b, s, h, p, n) == main or decay == "strong":
                    check(control > ops.BF16_REL, f"ssd_scan: the bf16-operand control is "
                          f"within {ops.BF16_REL:.0e} of plain ({tag}: {control:.3e}), so the "
                          f"check cannot see it")
            else:
                ok = ok and ey <= 1e-4
            check(ok and eh <= 1e-4, f"ssd_scan beyond its plain version ({tag}): y {ey:.3e}, "
                                     f"h_final {eh:.3e}")
            if ((b, s, h, p, n), dt) == (main, torch.bfloat16):
                self.record_err("ssd_scan", yf, rf)
            print(f"  ssd_scan ok: {tag}, y rel L2 {ey:.3e}{note} (max abs "
                  f"{float((yf - rf).abs().max()):.3e}), h_final rel L2 {eh:.3e}", flush=True)
            del args, y, y2, ry, hf, hf2, rh, yf, rf
        self.free()

    def main_path(self):
        torch = self.torch
        from repro_torch.core.swarm import BEHAVIOURS
        from repro_torch.launch import swarm as launch
        out = self.counted("showcase", lambda: launch.main(
            ["--full", "--rounds", str(SHOWCASE_ROUNDS)] + self.ckpt_args("showcase")))
        sw = out["swarm"]
        byz = {n.node_id for n in sw.nodes if n.byzantine in BEHAVIOURS[1:]}
        check(all(math.isfinite(l) for l in out["losses"]), "non-finite loss")
        check(sw.slashed <= byz, f"honest node slashed: {sorted(sw.slashed - byz)}")
        check(sw.ledger.check_conservation(), "ledger does not conserve")
        check(sw.fused, "the full-width showcase should take the fused path")
        print(f"  showcase: {out['seconds'] / out['rounds']:.3f} s/round, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"(the checkpoint's flat copy included), losses {out['losses']}, slashed "
              f"{sorted(sw.slashed)}", flush=True)
        self.hold_checkpoint(out)
        return out

    def hold_checkpoint(self, out):
        """The launcher's custody checkpoint of the trained params: restored
        by every holder it equals ``eval_params()`` bit for bit; two holders
        are refused with ``PermissionError``."""
        torch = self.torch
        from repro_torch.checkpoint import checkpoint as ckpt
        sw, custody = out["swarm"], out["custody"]
        holders = list(custody.node_ids)
        t0 = time.time()
        back = ckpt.restore_custody(out["ckpt"], sw.eval_params(), holders=holders)
        torch.cuda.synchronize()
        restore_s = time.time() - t0
        for k, v in sw.eval_params().items():
            bits = torch.int16 if v.dtype == torch.bfloat16 else torch.int32
            check(back[k].dtype == v.dtype and torch.equal(back[k].view(bits), v.view(bits)),
                  f"checkpoint: {k} restored by every holder differs from eval_params()")
        del back
        try:
            ckpt.restore_custody(out["ckpt"], sw.eval_params(), holders=holders[:2])
        except PermissionError as e:
            refused = str(e)
        else:
            raise PhaseFailed("checkpoint: two holders restored the params")
        files = list(Path(out["ckpt"]).iterdir())
        print(f"  custody checkpoint: {len(files)} files, "
              f"{sum(f.stat().st_size for f in files) / 1e9:.2f} GB, written in "
              f"{out['ckpt_seconds']:.3f} s (host clock, the launcher's partial-restore "
              f"refusal included); restored by all {len(holders)} holders in {restore_s:.3f} s, "
              f"bit-equal to eval_params(); two holders refused ({refused})", flush=True)
        shutil.rmtree(out["ckpt"], ignore_errors=True)

    def custody_lane(self, main_out):
        """Phase 4d: the showcase's roster and config with custody_leech's
        custody (``CUSTODY``) for the showcase's rounds, on counters of its
        own: custody only observes, so params, slashed, contrib and the
        records equal phase 4's run bit for bit, with the same launches;
        each round's coverage equals the host custody matrix's over the
        round's active nodes; the reconstruct attack of the coalition (the
        last quarter of the roster) keeps exactly its shards and zeroes the
        rest, and its loss is printed beside the honest one."""
        torch = self.torch
        from dataclasses import replace
        from repro_torch.core.unextractable import (CustodyConfig, masked_reconstruct,
                                                    shards_covered)
        from repro_torch.launch import swarm as launch
        problem, nodes, base = main_out["problem"], main_out["nodes"], main_out["swarm"]
        _, cfg = launch.showcase_roster(SHOWCASE_ROUNDS)
        sw = launch.make_showcase_swarm(problem, nodes, replace(cfg, custody=CustodyConfig(
            **CUSTODY)))
        self.counted("showcase_custody",
                     lambda: [sw.step(r) for r in range(SHOWCASE_ROUNDS)])
        torch.cuda.synchronize()
        for k, v in sw.params.items():
            check(torch.equal(v.view(torch.int32), base.params[k].view(torch.int32)),
                  f"custody lane: params[{k}] differ from the showcase's")
        check(torch.equal(sw.contrib.view(torch.int32), base.contrib.view(torch.int32))
              and sw.slashed == base.slashed, "custody lane: contrib or slashed differ")
        slashed, coverage = set(), []
        for h, hb in zip(sw.history, base.history[:SHOWCASE_ROUNDS]):
            check({k: v for k, v in h.items() if k != "coverage"}
                  == {k: v for k, v in hb.items() if k != "coverage"},
                  f"custody lane: round {h['round']}'s record differs: {h} / {hb}")
            active = [i for i, n in enumerate(nodes)
                      if n.active(h["round"]) and n.node_id not in slashed]
            check(h["coverage"] == float(sw.custody_matrix[active].any(0).mean()),
                  f"custody lane: round {h['round']} coverage {h['coverage']}")
            coverage.append(h["coverage"])
            slashed |= set(h["caught"])
        lane = sw._lane
        covered = shards_covered(lane.custody, lane.coalition)
        coal = [n.node_id for n, c in zip(nodes, lane.coalition.tolist()) if c]
        frac = float(covered.float().mean())
        check(frac < 1.0, f"custody lane: the coalition {coal} covers every shard")
        honest = sw.eval_params()
        with torch.no_grad():
            got = masked_reconstruct(honest, covered)
            flat_h = torch.cat([honest[k].reshape(-1).float() for k in sorted(honest)])
            flat_x = torch.cat([got[k].reshape(-1).float() for k in sorted(got)])
            size = flat_h.numel()
            pad = (-size) % CUSTODY["num_shards"]
            chunks_h = torch.nn.functional.pad(flat_h, (0, pad)).view(CUSTODY["num_shards"], -1)
            chunks_x = torch.nn.functional.pad(flat_x, (0, pad)).view(CUSTODY["num_shards"], -1)
            check(torch.equal(chunks_x[covered], chunks_h[covered])
                  and bool((chunks_x[~covered] == 0).all()),
                  "custody lane: the reconstruct attack does not keep exactly the "
                  "coalition's shards")
            del flat_h, flat_x, chunks_h, chunks_x
            honest_loss = problem.eval_loss(honest, len(nodes))
            extracted_loss = problem.eval_loss(got, len(nodes))
        del got
        check(math.isfinite(honest_loss) and math.isfinite(extracted_loss),
              "custody lane: non-finite loss")
        print(f"  custody lane: launches, params, slashed, contrib and records equal to phase "
              f"4's; coverage {coverage} (the host custody matrix's over the active nodes); "
              f"coalition {coal} holds {frac:.4f} of the shards; reconstruct-attack loss "
              f"{extracted_loss:.6f} beside the honest {honest_loss:.6f} (log V = "
              f"{math.log(problem.cfg.vocab_size):.6f})", flush=True)
        del sw

    def other_configs(self, main_out):
        from repro_torch.core.swarm import NodeSpec, SwarmConfig
        from repro_torch.launch import swarm as launch
        problem = main_out["problem"]
        showcase_nodes = main_out["nodes"]
        honest = [NodeSpec(f"h{i}") for i in range(N_NODES)]
        minority = ([NodeSpec(f"h{i}") for i in range(N_NODES - 2)]
                    + [NodeSpec(f"adv{i}", byzantine="sign_flip", byzantine_scale=10.0)
                       for i in range(2)])
        configs = [
            ("krum", showcase_nodes, SwarmConfig(aggregator="krum")),
            ("compressed_wire", honest, SwarmConfig(
                aggregator="mean", compression="qsgd",
                compression_kwargs={"levels": LEVELS_WIRE, "bucket_size": BUCKET})),
            ("sign_flip_minority", minority, SwarmConfig(aggregator="centered_clip")),
        ]
        for name, nodes, cfg in configs:
            sw = launch.make_showcase_swarm(problem, nodes, cfg)
            check(sw.fused, f"{name}: the full-width round should be fused")
            t0 = time.time()
            rec = self.counted(name, lambda: sw.step(0))
            self.torch.cuda.synchronize()
            loss = problem.eval_loss(sw.params, len(nodes))
            check(math.isfinite(rec["agg_norm"]) and math.isfinite(loss),
                  f"{name}: non-finite result")
            print(f"  {name}: 1 round {time.time() - t0:.3f} s, agg_norm "
                  f"{rec['agg_norm']:.4f}, loss {loss:.4f}", flush=True)
            if name == "compressed_wire":
                # a second round under the profiler: the round's device
                # time and the decode kernel's share of it
                _, events, busy_ms = self.profiled_round(sw, 1)
                dec_ms = sum(self_dev(e) for e in events if "decode_accumulate" in e.key)
                print(f"  {name}: profiled round 1, device busy {busy_ms:.1f} ms, "
                      f"decode_accumulate {dec_ms:.3f} ms of it", flush=True)
            del sw
            self.free()

    def fused_vs_unfused(self, main_out):
        torch = self.torch
        from dataclasses import replace
        from repro_torch.launch import swarm as launch
        from repro_torch.models.convert import flatten
        problem = main_out["problem"]
        nodes, cfg = launch.showcase_roster(3)
        outs = {}
        for fused in (True, False):
            sw = launch.make_showcase_swarm(problem, nodes, replace(cfg, fused=fused))
            check(sw.fused is fused, "fused flag not honoured")
            rec = sw.step(0)
            keep = sorted(n for op, n, _ in sw.ledger.history if op == "mint")
            outs[fused] = (rec, keep, flatten(sw.params))
            del sw
            self.free()
        (rf, kf, pf), (ru, ku, pu) = outs[True], outs[False]
        p0 = flatten(problem.params)
        check(rf["caught"] == ru["caught"], "caught differs fused vs unfused")
        check(kf == ku, "keep differs fused vs unfused")
        agg_rel = abs(rf["agg_norm"] - ru["agg_norm"]) / ru["agg_norm"]
        par_rel = float((pf - pu).norm() / (pu - p0).norm())
        print(f"  fused vs unfused: caught {rf['caught']} == {ru['caught']}, "
              f"agg_norm {rf['agg_norm']:.6f} vs {ru['agg_norm']:.6f} "
              f"(rel {agg_rel:.3e}), |dparams|/|update| {par_rel:.3e}", flush=True)
        # the aggregates differ only in float-sum order (~1e-6 relative);
        # AdamW's first step moves a coordinate by +-lr by the sign of its
        # aggregate, so a coordinate within rounding of zero may flip
        check(agg_rel <= 1e-5, "agg_norm differs fused vs unfused beyond 1e-5")
        check(par_rel <= 1e-2, "params differ fused vs unfused beyond 1e-2 of the update")

    def encode_and_cc_vs_plain(self):
        """Phase 2b: the QSGD encode kernel's codes equal to its plain
        version's, and the unmasked CenteredClip iteration within 3e-5 of
        its plain version, at the main paths' shapes and ragged ones."""
        torch = self.torch
        from repro_torch.core import compression
        from repro_torch.kernels.centered_clip import ops as cc
        from repro_torch.kernels.qsgd import ops as qenc

        def encode_case(x, bucket, levels, tag, main=False):
            nb = -(-x.numel() // bucket)
            g = torch.Generator(device=self.dev).manual_seed(nb + levels)
            u = torch.rand((nb, bucket), generator=g, device=self.dev)
            norms = compression.bucket_norms(compression.pad_buckets(x, bucket)).reshape(-1)
            out = qenc.qsgd_encode_kernel(x, u, norms, levels=levels, bucket_size=bucket)
            ref = qenc.qsgd_encode_plain(x, u, norms, levels=levels, bucket_size=bucket)
            check(torch.equal(out, ref), f"qsgd_encode codes differ from plain ({tag})")
            if main:
                self.record_err("qsgd_encode", out.float(), ref.float())
            print(f"  qsgd_encode codes equal: {tag}, {nb} buckets", flush=True)

        x = self.stack(1, D_FULL, seed=21)[0]
        encode_case(x, 512, 127, f"showcase wire L={D_FULL} bucket 512 levels 127", main=True)
        encode_case(x, BUCKET, LEVELS_WIRE, f"compressed_wire L={D_FULL} bucket {BUCKET} "
                                            f"levels {LEVELS_WIRE}")
        lanes = -(-D_FULL // qenc.LANE) * qenc.LANE
        g = torch.Generator(device=self.dev).manual_seed(3)
        u = torch.rand((lanes // qenc.LANE, qenc.LANE), generator=g, device=self.dev)
        codes, norm = qenc.qsgd_encode(x, u, levels=127)
        ref = qenc.qsgd_encode_plain(x, u, norm.reshape(1), levels=127, bucket_size=lanes)
        check(torch.equal(codes, ref), "qsgd_encode codes differ from plain (global norm)")
        print(f"  qsgd_encode codes equal: global-norm surface, {lanes // qenc.LANE} lanes",
              flush=True)
        del x, u, codes, ref
        self.free()
        for size in (7, 1000, 3 * 5 * 17):
            for levels in (16, 64, 127):
                x = self.stack(1, size, seed=size)[0]
                encode_case(x, -(-size // qenc.LANE) * qenc.LANE, levels,
                            f"L={size} one bucket levels {levels}")
                encode_case(x, 128, levels, f"L={size} bucket 128 levels {levels}")

        cases = [(N_NODES, D_FULL)] + [(k, d) for k in (1, 2, 3, 7) for d in (257, 1000)]
        for k, d in cases:
            x = self.stack(k, d, seed=k)
            v = self.stack(1, d, seed=99)[0] * 0.5
            for tau in (2.0, None):
                o = cc.cc_iter(x, v, clip_tau=tau)
                again = cc.cc_iter(x, v, clip_tau=tau)
                r = cc.cc_iter_plain(x, v, tau)
                tag = f"k={k} D={d} tau={tau}"
                check(torch.equal(o, again), f"cc_iter: two launches differ ({tag})")
                check(bool(((o - r).abs() <= 3e-5 + 3e-5 * r.abs()).all()),
                      f"cc_iter beyond 3e-5 of its plain version ({tag})")
                err = self.record_err("cc_iter", o, r) if (k, d) == cases[0] else \
                    float((o - r).abs().max())
                print(f"  cc_iter ok: {tag}, max abs err {err:.3e}", flush=True)
                del o, again, r
                self.chain_vs_iters(
                    lambda vv, t=tau: cc.cc_iter(x, vv, clip_tau=t),
                    lambda vv, t=tau: cc.cc_iter_plain(x, vv, t),
                    lambda vv, t=tau: cc.cc_chain(x, vv, iters=CC_ITERS, clip_tau=t),
                    v, f"cc_chain ({tag})", "cc_iter" if (k, d) == cases[0] else None)
            del x, v
            self.free()

    def chain_vs_iters(self, one, plain, chain, v0, tag, err_name):
        """Phases 2 and 2b: a CenteredClip chain of ``CC_ITERS`` iterations
        from ``v0`` bit-equal to as many single-iteration calls (``one``) and
        to a second chain, and within 3e-5 of as many plain iterations (NaN
        where both are).  The error to plain counts for ``err_name``'s
        row."""
        torch = self.torch
        a = chain(v0)
        v = v0
        for _ in range(CC_ITERS):
            v = one(v)
        check(self.bit_equal(a, v), f"{tag}: the chain differs from {CC_ITERS} single "
                                    f"iterations")
        del v
        check(self.bit_equal(a, chain(v0)), f"{tag}: two chains differ")
        r = v0
        for _ in range(CC_ITERS):
            r = plain(r)
        ok = ((a - r).abs() <= 3e-5 + 3e-5 * r.abs()) | (a.isnan() & r.isnan())
        check(bool(ok.all()), f"{tag}: the chain is beyond 3e-5 of {CC_ITERS} plain "
                              f"iterations")
        err = self.record_err(err_name, a, r) if err_name else \
            float(torch.nan_to_num((a - r).abs()).max())
        print(f"  {tag}: chain of {CC_ITERS} bit-equal to {CC_ITERS} single iterations and to "
              f"a second chain, max abs err to plain {err:.3e}", flush=True)
        del a, r
        self.free()

    def sequential_path(self):
        """Phase 4b: the showcase on the sequential engine at full width,
        on counters of its own, with phase 4's checks; then more rounds
        timed and one profiled."""
        torch = self.torch
        from repro_torch.core.swarm import BEHAVIOURS, SequentialSwarm
        from repro_torch.launch import swarm as launch
        held = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        out = self.counted("showcase_sequential", lambda: launch.main(
            ["--full", "--rounds", str(SHOWCASE_ROUNDS), "--engine", "sequential"]
            + self.ckpt_args("showcase_sequential")))
        sw = out["swarm"]
        byz = {n.node_id for n in sw.nodes if n.byzantine in BEHAVIOURS[1:]}
        check(isinstance(sw, SequentialSwarm), "not the sequential engine")
        check(all(math.isfinite(l) for l in out["losses"]), "non-finite loss")
        check(sw.slashed <= byz, f"honest node slashed: {sorted(sw.slashed - byz)}")
        check(sw.ledger.check_conservation(), "ledger does not conserve")
        print(f"  showcase_sequential: {out['seconds'] / out['rounds']:.3f} s/round, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({held:.2f} GiB held before it), losses {out['losses']}, slashed "
              f"{sorted(sw.slashed)}", flush=True)
        self.profile_rounds(sw, "cc_iter")
        return out

    def engines_agree(self, main_out):
        """Phase 6c: round 0 of the showcase on both engines from the same
        init and seed.  The gradients, the draws and the wire codes are the
        same; only the aggregation's float order differs (masked median and
        Σ/k over the kept rows of the stack, against the dense median and
        Σ·(1/k) over the compacted survivors).  The aggregate each engine
        hands the optimizer is read where it is unflattened."""
        from repro_torch.core import swarm as swarm_mod
        from repro_torch.launch import swarm as launch
        problem = main_out["problem"]
        nodes, cfg = launch.showcase_roster(SHOWCASE_ROUNDS)
        unflatten = swarm_mod.unflatten
        aggs, outs = {}, {}
        for engine in ("batched", "sequential"):
            def recording(vec, layout, engine=engine):
                aggs[engine] = vec.detach().clone()
                return unflatten(vec, layout)
            swarm_mod.unflatten = recording
            try:
                sw = launch.make_showcase_swarm(problem, nodes, cfg, engine=engine)
                rec = sw.step(0)
            finally:
                swarm_mod.unflatten = unflatten
            outs[engine] = (rec, sorted(n for op, n, _ in sw.ledger.history if op == "mint"))
            del sw
            self.free()
        (rb, kb), (rs, ks) = outs["batched"], outs["sequential"]
        check(rb["n_active"] == rs["n_active"], "n_active differs between the engines")
        check(rb["caught"] == rs["caught"], "caught differs between the engines")
        check(kb == ks, "the minted (kept) nodes differ between the engines")
        a, b = aggs["batched"], aggs["sequential"]
        rel = float((a - b).norm() / a.norm())
        gap = abs(rb["agg_norm"] - rs["agg_norm"]) / rb["agg_norm"]
        print(f"  batched vs sequential, round 0: n_active {rb['n_active']}, caught "
              f"{rb['caught']}, kept {len(kb)}; aggregates {rel:.3e} relative L2 apart, "
              f"agg_norm {rb['agg_norm']:.6f} vs {rs['agg_norm']:.6f} (gap {gap:.3e})",
              flush=True)
        check(rel <= 1e-5, f"the engines' aggregates differ by {rel:.3e} relative L2 (bound 1e-5)")

    def no_off_smoke(self):
        """Phase 10: the ``no_off_smoke`` sweep on the tiny quadratic, on the
        card (its CenteredClip lanes through the kernels, on counters of
        their own) and on the CPU (the unfused plain path) from the same
        bits: the phase tables equal as strings, each cell's discrete
        fields equal, finite final and baseline losses within
        NO_OFF_LOSS_REL relative, a non-finite loss non-finite on both."""
        from repro_torch.core import derailment, scenarios
        from repro_torch.launch import problems
        grid = scenarios.get_sweep_grid("no_off_smoke")

        def run(device):
            loss_fn, params, data_fn, eval_fn, opt = problems.tiny_quadratic_problem(
                device=device)
            return derailment.sweep(loss_fn, params, opt, data_fn, eval_fn, grid)

        card = self.counted("no_off_smoke", lambda: run("cuda"))
        self.hold_tables("no_off_smoke (tiny quadratic, 16 params)", card, run("cpu"),
                         NO_OFF_LOSS_REL)

    def show_table(self, what, res, rounds):
        print(f"  {what} phase table ({res.n_runs} lanes, {rounds} rounds, "
              f"{res.wall_s:.3f} s):\n"
              + "\n".join("    " + line for line in res.phase_table().splitlines()), flush=True)

    def hold_tables(self, what, card, cpu, loss_rel):
        """Card against CPU: the phase tables equal as strings, each cell's
        discrete fields equal, finite final and baseline losses within
        ``loss_rel`` relative, a non-finite loss non-finite on both."""
        self.show_table(f"{what} on the card", card, card.grid.rounds)
        table = card.phase_table()
        check(table == cpu.phase_table(),
              f"phase tables differ, card:\n{table}\nCPU:\n{cpu.phase_table()}")
        worst = 0.0
        for a, b in zip(card.results, cpu.results):
            for field in ("regime", "topology", "staleness_bound", "redundancy",
                          "coalition_fraction", "n_attackers", "derailed", "attackers_slashed"):
                check(getattr(a, field) == getattr(b, field),
                      f"{field} differs card vs CPU: {a} / {b}")
            for field in ("final_loss", "baseline_loss"):
                x, y = getattr(a, field), getattr(b, field)
                check(math.isfinite(x) == math.isfinite(y), f"{field} finite on one side: {a}")
                if math.isfinite(y):
                    rel = abs(x - y) / max(abs(y), 1e-30)
                    worst = max(worst, rel)
                    check(rel <= loss_rel, f"{field} {x} vs {y}, rel {rel:.3e}")
        print(f"  card vs CPU: tables equal, discrete fields equal, losses within "
              f"{worst:.3e} relative (bound {loss_rel:g}); final losses "
              f"{[r.final_loss for r in card.results]}", flush=True)

    def decentralized_path(self):
        """Phase 4c: ``python -m repro_torch.launch.swarm --full --scenario
        byzantine_neighborhood --nodes 10 --rounds 2`` on counters of its
        own: per-node replicas, each node's neighbourhood through the masked
        median and the CenteredClip chain, the gossip mix.  Node 3's round-1
        aggregate (recorded with its stack and mask as the round makes it)
        bit-equal to a lone ``masked_centered_clip_fused`` call and within
        3e-5 of the plain version; finite consensus error and losses; then
        rounds timed on CUDA events, one profiled (the busy share), the peak
        memory; last one round of the roster on ``fully_connected`` against
        the centralized round from the same state."""
        torch = self.torch
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.launch import swarm as launch
        fused_cc = magg.FUSED_MASKED_AGGREGATORS["centered_clip"]
        held, calls = {}, [0]

        def recording(updates, mask, **kw):
            out = fused_cc(updates, mask, **kw)
            if calls[0] == DEC_HELD_CALL:
                held.update(x=updates.clone(), mask=mask.clone(), out=out.clone(), kw=kw)
            calls[0] += 1
            return out

        magg.FUSED_MASKED_AGGREGATORS["centered_clip"] = recording
        try:
            out = self.counted("byzantine_neighborhood", lambda: launch.main(
                ["--full", "--scenario", "byzantine_neighborhood", "--nodes", str(N_NODES),
                 "--rounds", str(DEC_ROUNDS)] + self.ckpt_args("byzantine_neighborhood")))
        finally:
            magg.FUSED_MASKED_AGGREGATORS["centered_clip"] = fused_cc
        torch.cuda.synchronize()
        sw = out["swarm"]
        w = sw._lane.mixing
        check(sw.fused, "byzantine_neighborhood: the card's neighbourhoods should be fused")
        check(tuple(sw.params["embed"].shape[:1]) == (N_NODES,), "not per-node replicas")
        check(all(math.isfinite(l) for l in out["losses"]), "non-finite loss")
        check(all(math.isfinite(h["consensus_error"]) and h["consensus_error"] > 0
                  for h in sw.history), f"consensus_error {[h['consensus_error'] for h in sw.history]}")
        check(sw.ledger.check_conservation() and not sw.slashed, "ledger or slashing off")
        node = DEC_HELD_CALL % N_NODES
        check(calls[0] == N_NODES * DEC_ROUNDS and torch.equal(held["mask"], w[node] > 0),
              "the recorded aggregation is not node 3's neighbourhood")
        lone = magg.masked_centered_clip_fused(held["x"], held["mask"], **held["kw"])
        check(self.bit_equal(lone, held["out"]),
              "node 3's aggregate differs from a lone masked_centered_clip_fused call")
        v = magg.masked_median_plain(held["x"], held["mask"])
        for _ in range(CC_ITERS):
            v = magg.masked_cc_iter_plain(held["x"], v, held["mask"], None)
        err = float((held["out"] - v).abs().max())
        check(bool(((held["out"] - v).abs() <= 3e-5 + 3e-5 * v.abs()).all()),
              f"node 3's aggregate beyond 3e-5 of the plain version ({err:.3e})")
        del lone, v
        degrees = (w > 0).sum(1).tolist()
        print(f"  byzantine_neighborhood: {N_NODES} replicas, neighbourhoods of "
              f"{degrees} nodes (self included); node {node}'s round-1 aggregate bit-equal "
              f"to a lone masked_centered_clip_fused call, max abs {err:.3e} from the plain "
              f"version; consensus_error {[h['consensus_error'] for h in sw.history]}; "
              f"losses {out['losses']}; launcher {out['seconds'] / out['rounds']:.3f} s/round",
              flush=True)
        held.clear()
        self.free()
        # the peak of rounds without the check's copy of the stack: the
        # engine's state beside the round's
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for r in range(DEC_ROUNDS, DEC_ROUNDS + 2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sw.step(r)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated()
        wall_ms, events, busy_ms = self.profiled_round(sw, DEC_ROUNDS + 2)
        print(f"  decentralized rounds on CUDA events: {[round(x, 1) for x in ms]} ms, "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"profiled round {wall_ms:.1f} ms wall with the profiler on, device busy "
              f"{busy_ms:.1f} ms = {busy_ms / min(ms):.1%} of the faster unprofiled round",
              flush=True)
        for e in sorted(events, key=self_dev, reverse=True)[:10]:
            print(f"    {self_dev(e):9.2f} ms  x{e.count:<5d} {e.key[:90]}", flush=True)
        problem, nodes, cfg = out["problem"], out["nodes"], sw.cfg
        del out, sw, events
        self.free()
        self.fully_connected_vs_centralized(problem, nodes, cfg)

    def async_path(self):
        """Phase 4e: ``python -m repro_torch.launch.swarm --full --scenario
        stale_poisoning --nodes 10 --rounds 4`` on counters of its own (the
        async round, K = 3: a median and a chain of 3 a round).  Each
        round's staleness equals the mean, over the active nodes, of the
        delays the host draws from the same schedule, each at most min(cap,
        round, K); the row a stale attacker submitted in the round of the
        largest delay is bit-equal to its gradient recomputed alone at its
        snapshot, sign-flipped; no honest node is slashed.  Then two rounds
        on CUDA events and the peak memory."""
        torch = self.torch
        from repro_torch.core.scenarios import get_scenario
        from repro_torch.core.swarm import _node_gradient
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.launch import swarm as launch
        from repro_torch.models.convert import flatten_into
        from repro_torch.random import RoundRandom
        nodes = get_scenario("stale_poisoning").make_nodes(N_NODES)
        caps = [min(n.effective_delay, ASYNC_BOUND) for n in nodes]
        delays = [[RoundRandom(0, r, self.dev).delay(i, min(c, r, ASYNC_BOUND))
                   for i, c in enumerate(caps)] for r in range(ASYNC_ROUNDS)]
        held_r = max(range(ASYNC_ROUNDS), key=lambda r: max(delays[r]))
        held_i = max(range(N_NODES), key=lambda i: delays[held_r][i])
        fused_cc = magg.FUSED_MASKED_AGGREGATORS["centered_clip"]
        held, calls = {}, [0]

        def recording(updates, mask, **kw):
            if calls[0] == held_r:
                held["row"] = updates[held_i].clone()
            calls[0] += 1
            return fused_cc(updates, mask, **kw)

        magg.FUSED_MASKED_AGGREGATORS["centered_clip"] = recording
        try:
            out = self.counted("stale_poisoning", lambda: launch.main(
                ["--full", "--scenario", "stale_poisoning", "--nodes", str(N_NODES),
                 "--rounds", str(ASYNC_ROUNDS)] + self.ckpt_args("stale_poisoning")))
        finally:
            magg.FUSED_MASKED_AGGREGATORS["centered_clip"] = fused_cc
        torch.cuda.synchronize()
        sw = out["swarm"]
        honest = {n.node_id for n in nodes if n.byzantine is None}
        check(sw.fused and sw.cfg.staleness_bound == ASYNC_BOUND, "not the fused async round")
        check(not sw.slashed & honest, f"honest node slashed: {sorted(sw.slashed & honest)}")
        check(all(math.isfinite(l) for l in out["losses"]) and sw.ledger.check_conservation(),
              "non-finite loss or ledger off")
        slashed = set()
        for r, h in enumerate(sw.history):
            active = torch.tensor([n.active(r) and n.node_id not in slashed for n in nodes],
                                  dtype=torch.float32)
            want = float(torch.sum(torch.tensor(delays[r], dtype=torch.float32) * active)
                         / torch.clamp(torch.sum(active), min=1.0))
            check(h["staleness"] == want, f"round {r}: staleness {h['staleness']} vs {want}")
            check(all(d <= min(c, r, ASYNC_BOUND) for d, c in zip(delays[r], caps)),
                  f"round {r}: a delay above its cap")
            slashed |= set(h["caught"])
        d = delays[held_r][held_i]
        check(d > 0, "no delay above 0 was drawn")
        snapshot = sw._ring[(held_r - d) % (ASYNC_BOUND + 1)]
        g = torch.empty_like(held["row"])
        flatten_into(g, _node_gradient(sw.loss_fn, snapshot, sw.data_fn(held_i, held_r)))
        row = -sw._lane.scales[held_i] * g
        check(self.bit_equal(row, held["row"]),
              f"node {held_i}'s round-{held_r} row differs from its gradient at round "
              f"{held_r - d}'s params, sign-flipped")
        del g, row, snapshot
        held.clear()
        print(f"  stale_poisoning: realized delays {delays} (caps {caps}); staleness "
              f"{[h['staleness'] for h in sw.history]}; node {held_i}'s round-{held_r} row "
              f"(delay {d}) bit-equal to its gradient at round {held_r - d}'s params recomputed "
              f"alone; slashed {sorted(sw.slashed)}; losses {out['losses']}; launcher "
              f"{out['seconds'] / out['rounds']:.3f} s/round; custody checkpoint "
              f"{out['ckpt_seconds']:.3f} s", flush=True)
        shutil.rmtree(out["ckpt"], ignore_errors=True)
        del out
        self.free()
        ms = []
        for r in range(ASYNC_ROUNDS, ASYNC_ROUNDS + 2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sw.step(r)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        print(f"  async rounds {ASYNC_ROUNDS}-{ASYNC_ROUNDS + 1} on CUDA events: "
              f"{[round(x / 1e3, 4) for x in ms]} s; max_memory_allocated of the phase "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the ring holds "
              f"{ASYNC_BOUND + 1} param dicts by reference)", flush=True)

    def economy_path(self):
        """Phase 4f: ``python -m repro_torch.launch.swarm --full --scenario
        economy_sybil_adaptive --nodes 10 --rounds 3`` on counters of its own
        (each round the 4 scored CenteredClips of the best response, then
        the round's own).  Round 0's scored aggregates, on the same stacks:
        within 3e-5 of the kernels' plain version (the median and 3
        iterations, as phase 4c holds a neighbourhood), elementwise relative
        to the column's largest entry beside the value itself (a column's
        sums cancel: the coalition's rows reach ~1e6 where the aggregate is
        near 0, so the rounding of the sum is relative to its terms); within
        ECON_AGG_REL relative L2 of ``core.aggregation.masked_centered_clip``,
        the reference's route (phase 6's fused-against-unfused bound), their
        scores within 3e-5 relative of its scores (the honest mean read back
        from a coalition row, ``-s · mean`` with s a power of two) and the
        same best scale (a near-tie is printed instead); the coalition's
        round-0 rows are that scale's; the conservation gap is held after
        every round; then two rounds on CUDA events and their peak
        memory."""
        torch = self.torch
        from repro_torch.core import aggregation, economy
        from repro_torch.core.scenarios import get_scenario
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.launch import swarm as launch
        scales = economy.ADAPTIVE_SCALES
        check(len(scales) == ECON_SCORED, f"ECON_SCORED is not len({scales})")
        nodes = get_scenario("economy_sybil_adaptive").make_nodes(N_NODES)
        row = [i for i, n in enumerate(nodes) if n.byzantine is not None][0]
        fused_cc = magg.FUSED_MASKED_AGGREGATORS["centered_clip"]
        update = economy.econ_round_update
        scored, gaps, calls, held = [], [], [0], {}

        def recording(updates, mask, **kw):
            out = fused_cc(updates, mask, **kw)
            k = calls[0]
            calls[0] += 1
            if k < len(scales):                 # round 0's scored stacks, in menu order
                hm = updates[row] / -scales[k]
                held.setdefault("hm", hm)
                v = magg.masked_median_plain(updates, mask)
                for _ in range(CC_ITERS):
                    v = magg.masked_cc_iter_plain(updates, v, mask, None)
                # the rounding of a column's sums is relative to its terms
                terms = updates.abs().amax(0) + v.abs()
                chain_rel = float(((out - v).abs() / (1.0 + terms)).max())
                chain_ok = bool(((out - v).abs() <= 3e-5 + 3e-5 * terms).all())
                chain_err = float((out - v).abs().max())
                del v, terms
                ref = aggregation.masked_centered_clip(updates, mask, **kw)
                at = int((out - ref).abs().argmax())
                scored.append(dict(
                    kernel=float(-torch.dot(out, hm)), ref=float(-torch.dot(ref, hm)),
                    chain_ok=chain_ok, chain_err=chain_err, chain_rel=chain_rel,
                    ref_rel=float((out - ref).norm() / ref.norm()),
                    ref_abs=float((out - ref).abs().max()), at=(float(out[at]), float(ref[at]))))
            elif k == len(scales):              # round 0's own aggregation
                hm = held.pop("hm")
                held["submitted"] = float(-torch.dot(updates[row], hm) / torch.dot(hm, hm))
            return out

        def recording_update(*args, **kw):
            st = update(*args, **kw)
            inflow = float(torch.sum(st.capital_in) + st.minted + st.fees_in)
            gaps.append((float(economy.conservation_gap(st)), inflow))
            return st

        magg.FUSED_MASKED_AGGREGATORS["centered_clip"] = recording
        economy.econ_round_update = recording_update
        try:
            out = self.counted("economy_sybil_adaptive", lambda: launch.main(
                ["--full", "--scenario", "economy_sybil_adaptive", "--nodes", str(N_NODES),
                 "--rounds", str(ECON_ROUNDS)] + self.ckpt_args("economy_sybil_adaptive")))
        finally:
            magg.FUSED_MASKED_AGGREGATORS["centered_clip"] = fused_cc
            economy.econ_round_update = update
        torch.cuda.synchronize()
        sw = out["swarm"]
        check(sw.fused and sw._lane.econ.adaptive == 1, "not the fused adaptive economy round")
        check(calls[0] == ECON_ROUNDS * (1 + ECON_SCORED), f"{calls[0]} CenteredClip calls")
        check(all(math.isfinite(l) for l in out["losses"]) and sw.ledger.check_conservation(),
              "non-finite loss or ledger off")
        submitted = held["submitted"]
        kernel = [s["kernel"] for s in scored]
        plain = [s["ref"] for s in scored]
        for s, d in zip(scales, scored):
            print(f"  scale {s}: kernel vs its plain version max abs {d['chain_err']:.3e}, "
                  f"{d['chain_rel']:.3e} of 1 + the column's largest term; "
                  f"vs core.aggregation relative L2 {d['ref_rel']:.3e}, max abs "
                  f"{d['ref_abs']:.3e} (there {d['at'][0]!r} / {d['at'][1]!r}); scores "
                  f"{d['kernel']!r} / {d['ref']!r}", flush=True)
        for s, d in zip(scales, scored):
            check(d["chain_ok"], f"scale {s}: the scored aggregate is beyond 3e-5 of the "
                                 f"kernels' plain version ({d['chain_rel']:.3e})")
            check(d["ref_rel"] <= ECON_AGG_REL,
                  f"scale {s}: relative L2 {d['ref_rel']:.3e} from the unfused aggregate")
            check(abs(d["kernel"] - d["ref"]) <= 3e-5 * abs(d["ref"]),
                  f"scale {s}: score {d['kernel']} vs {d['ref']}")
        best = max(range(len(scales)), key=lambda i: (kernel[i], -i))
        ref_best = max(range(len(scales)), key=lambda i: (plain[i], -i))
        spread = max(abs(a - b) for a, b in zip(kernel, plain))
        top2 = sorted(plain)[-2:]
        if top2[1] - top2[0] > spread:
            check(best == ref_best, f"best scale {scales[best]} (kernel) vs "
                                    f"{scales[ref_best]} (unfused)")
        else:
            print(f"  near-tie: the unfused scores' top two are {top2[1] - top2[0]:.3e} "
                  f"apart, within the routes' {spread:.3e}", flush=True)
        check(abs(submitted - scales[best]) <= 1e-3 * scales[best],
              f"the coalition submitted {submitted} x the honest mean, not {scales[best]}")
        for r, (gap, inflow) in enumerate(gaps):
            check(gap <= ECON_GAP_REL * inflow, f"round {r}: conservation gap {gap} of {inflow}")
        econ = sw._econ_state
        print(f"  economy_sybil_adaptive: round-0 scores kernel {kernel} / unfused {plain} "
              f"(scales {list(scales)}); best {scales[best]}, submitted "
              f"{submitted:.6f}; coalition_stake {[h['coalition_stake'] for h in sw.history]}; "
              f"n_active {[h['n_active'] for h in sw.history]}; slashed {sorted(sw.slashed)}; "
              f"stakes {[round(x, 4) for x in econ.stake.tolist()]}; conservation gaps "
              f"{[g for g, _ in gaps]} of inflows {[i for _, i in gaps]}; losses "
              f"{out['losses']}; launcher {out['seconds'] / out['rounds']:.3f} s/round; "
              f"max_memory_allocated of the launcher's run and the checks "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {self.card_name()}",
              flush=True)
        shutil.rmtree(out["ckpt"], ignore_errors=True)
        scored.clear()
        del out
        self.free()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for r in range(ECON_ROUNDS, ECON_ROUNDS + 2):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sw.step(r)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        print(f"  economy rounds {ECON_ROUNDS}-{ECON_ROUNDS + 1} on CUDA events: "
              f"{[round(x / 1e3, 4) for x in ms]} s; max_memory_allocated of those rounds "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {self.card_name()}",
              flush=True)

    def no_off_economy(self):
        """Phase 10g: the ``no_off_economy_smoke`` sweep on the tiny
        quadratic, on the card (its CenteredClip lanes through the median
        and the chain, on counters of their own; the CPU run's audit draws
        handed in) and on the CPU: the phase tables and cells held as phase
        10's, both regimes' economy tables, fixed and adaptive, equal as
        strings, each cell's outcome, coalition size and admitted counts
        equal, payoffs and stake shares within NO_OFF_LOSS_REL (1e-6
        absolute), the adaptive gap over 8 cells."""
        torch = self.torch
        from repro_torch.core import derailment, scenarios
        from repro_torch.launch import problems
        from repro_torch.random import RoundDraws, RoundRandom
        grid = scenarios.get_sweep_grid("no_off_economy_smoke")
        spec = derailment.build_sweep_lanes(grid)
        n, cpu = spec.n_total, torch.device("cpu")

        def draws(j, rnd):
            """The CPU run's audit draws of lane j, round rnd."""
            rr = RoundRandom(spec.lanes[j].seed, rnd, cpu)
            return RoundDraws(audit_sel=torch.stack([rr.audit_sel(i) for i in range(n)]),
                              audit_noise=torch.stack([rr.audit_noise(i, 16) for i in range(n)]))

        def run(device, draws_fn=None):
            loss_fn, params, data_fn, eval_fn, opt = problems.tiny_quadratic_problem(
                device=device)
            return derailment.sweep(loss_fn, params, opt, data_fn, eval_fn, grid,
                                    draws_fn=draws_fn)

        card = self.counted("no_off_economy_smoke", lambda: run("cuda", draws))
        cpu_res = run("cpu")
        self.hold_tables("no_off_economy_smoke (tiny quadratic, 16 params)", card, cpu_res,
                         NO_OFF_LOSS_REL)
        for regime in ("mean+audit", "centered_clip+audit"):
            for adaptive in (False, True):
                table = card.economy_phase_table(regime, adaptive=adaptive)
                print(f"  {regime}, {'adaptive' if adaptive else 'fixed'} coalition, on the "
                      "card:\n" + "\n".join("    " + line for line in table.splitlines()),
                      flush=True)
                check(table == cpu_res.economy_phase_table(regime, adaptive=adaptive),
                      f"{regime} economy tables differ card vs CPU")
        worst = 0.0
        for a, b in zip(card.econ_results, cpu_res.econ_results):
            for f in ("regime", "identity_cost", "fee", "adaptive", "coalition_size",
                      "outcome", "n_admitted_first", "n_admitted_last"):
                check(getattr(a, f) == getattr(b, f), f"{f} differs card vs CPU: {a} / {b}")
            for f in ("honest_payoff", "coalition_payoff", "coalition_stake_share"):
                x, y = getattr(a, f), getattr(b, f)
                worst = max(worst, abs(x - y) / max(abs(y), 1e-30))
                check(abs(x - y) <= NO_OFF_LOSS_REL * abs(y) + 1e-6, f"{f} {x} vs {y}")
        gap = card.economy_adaptive_gap()
        check(gap["cells"] == 8 and len(card.econ_results) == grid.n_points,
              f"adaptive gap {gap}")
        print(f"  economy cells card vs CPU: outcomes and admitted counts equal, payoffs "
              f"within {worst:.3e} relative; adaptive gap {gap}; {self.card_name()}",
              flush=True)

    def no_off_async(self):
        """Phase 10e: the ``no_off_async_smoke`` sweep (CenteredClip at K =
        0 and 2 against 2 and 6 inner-product attackers beside 6 honest, 8
        rounds, baselines per bound) on the tiny quadratic, on the card (its
        4 CenteredClip lanes through the median and the chain) and on the
        CPU: the delays are drawn on the host, so both draw the same ones;
        tables and cells held as phase 10's."""
        from repro_torch.core import derailment, scenarios
        from repro_torch.launch import problems
        grid = scenarios.get_sweep_grid("no_off_async_smoke")

        def run(device):
            loss_fn, params, data_fn, eval_fn, opt = problems.tiny_quadratic_problem(
                device=device)
            return derailment.sweep(loss_fn, params, opt, data_fn, eval_fn, grid)

        card = self.counted("no_off_async_smoke", lambda: run("cuda"))
        self.hold_tables("no_off_async_smoke (tiny quadratic, 16 params)", card, run("cpu"),
                         NO_OFF_LOSS_REL)

    def custody_smoke(self):
        """Phase 10f: the ``custody_smoke`` sweep (mean, redundancy 1 and 2
        against coalitions of half and all of 6 honest nodes, a third of
        them churning out, 8 rounds, the reconstruct attack in every lane)
        on the tiny quadratic, card against CPU: the extractability and
        phase tables equal as strings, the coverage traces exactly equal,
        the final, baseline and extracted losses within NO_OFF_LOSS_REL."""
        from repro_torch.core import derailment, scenarios
        from repro_torch.launch import problems
        grid = scenarios.get_sweep_grid("custody_smoke")

        def run(device):
            loss_fn, params, data_fn, eval_fn, opt = problems.tiny_quadratic_problem(
                device=device)
            return derailment.sweep(loss_fn, params, opt, data_fn, eval_fn, grid,
                                    return_campaign=True)

        card, (_, card_recs, _) = self.counted("custody_smoke", lambda: run("cuda"))
        cpu, (_, cpu_recs, _) = run("cpu")
        table = card.extractability_table()
        print("  custody_smoke extractability table on the card:\n"
              + "\n".join("    " + line for line in table.splitlines()), flush=True)
        check(table == cpu.extractability_table(),
              f"extractability tables differ, CPU:\n{cpu.extractability_table()}")
        check(self.torch.equal(card_recs.coverage.cpu(), cpu_recs.coverage),
              "coverage traces differ card vs CPU")
        worst = 0.0
        for a, b in zip(card.results, cpu.results):
            check(math.isfinite(a.extracted_loss) and math.isfinite(b.extracted_loss),
                  f"non-finite extracted loss: {a}")
            rel = abs(a.extracted_loss - b.extracted_loss) / max(abs(b.extracted_loss), 1e-30)
            worst = max(worst, rel)
            check(rel <= NO_OFF_LOSS_REL, f"extracted loss {a.extracted_loss} vs "
                                          f"{b.extracted_loss}, rel {rel:.3e}")
        self.hold_tables("custody_smoke (tiny quadratic, 16 params)", card, cpu, NO_OFF_LOSS_REL)
        print(f"  custody_smoke: coverage traces equal, extracted losses "
              f"within {worst:.3e} relative; last-round coverage "
              f"{card_recs.coverage[:, -1].tolist()}", flush=True)

    def fully_connected_vs_centralized(self, problem, nodes, cfg):
        """Round 0 of the roster on ``fully_connected`` (every replica
        aggregates every kept node, then the mix of identical replicas)
        against the centralized round from the same init: equal
        ``n_active`` and ``caught``, agg_norm within FC_AGG_REL, the
        consensus replica within FC_AGG_REL of the centralized params'
        update (relative L2)."""
        from dataclasses import replace
        from repro_torch.launch import swarm as launch
        from repro_torch.models.convert import flatten
        recs, flat = {}, {}
        for topo in ("fully_connected", None):
            sw = launch.make_showcase_swarm(problem, nodes, replace(cfg, topology=topo))
            recs[topo] = sw.step(0)
            flat[topo] = flatten(sw.eval_params())
            del sw
            self.free()
        a, b = recs["fully_connected"], recs[None]
        check((a["n_active"], a["caught"]) == (b["n_active"], b["caught"]),
              "fully_connected and centralized differ in n_active or caught")
        agg_rel = abs(a["agg_norm"] - b["agg_norm"]) / b["agg_norm"]
        p0 = flatten(problem.params)
        par_rel = float((flat["fully_connected"] - flat[None]).norm() / (flat[None] - p0).norm())
        print(f"  fully_connected vs centralized, round 0: agg_norm {a['agg_norm']:.6f} vs "
              f"{b['agg_norm']:.6f} (rel {agg_rel:.3e}), consensus_error "
              f"{a['consensus_error']:.3e}, |dparams|/|update| {par_rel:.3e} (bound "
              f"{FC_AGG_REL:g})", flush=True)
        check(agg_rel <= FC_AGG_REL and par_rel <= FC_AGG_REL,
              "fully_connected parts from the centralized round")

    def no_off_lm(self):
        """Phase 10c: the no_off_lm grid of ``launch/derailment_no_off.py``
        on ``launch.problems.small_lm_problem`` (rounds cut to
        NO_OFF_LM_ROUNDS), run free on the card as a user calls it (on
        counters of its own, the CPU run's audit draws handed in), then
        lane by lane on the CPU with each round of the card run from the
        CPU's state: every round's discrete fields equal, agg_norm within
        NO_OFF_LM_AGG_REL until the model blows up, the final losses within
        NO_OFF_LM_LOSS_REL where the lane has not blown up, both within
        NO_OFF_LM_BLOWN_REL where it has (finite on both sides or neither),
        and the phase tables from the CPU run and from
        the card's rounds equal as strings.  The free card run's table is
        printed beside the CPU's (the lr-0.5 LM multiplies a float
        difference ~30x a round, so free runs part)."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import derailment
        from repro_torch.core import swarm as tswarm
        from repro_torch.launch import derailment_no_off, problems
        from repro_torch.models.convert import flat_size, layout_of
        from repro_torch.random import RoundDraws, RoundRandom
        grid = derailment_no_off.no_off_lm_grid(rounds=NO_OFF_LM_ROUNDS)
        spec = derailment.build_sweep_lanes(grid)
        n, rounds, cpu = spec.n_total, grid.rounds, torch.device("cpu")
        kl, kp, kd, ke, ko = problems.small_lm_problem("cuda")
        cl, cp, cd, ce, co = problems.small_lm_problem("cpu")
        d = flat_size(layout_of(cp))

        def draws(j, rnd):
            """The CPU run's audit draws of lane j, round rnd."""
            rr = RoundRandom(spec.lanes[j].seed, rnd, cpu)
            noise = (torch.stack([rr.audit_noise(i, d) for i in range(n)])
                     if spec.lanes[j].p_check > 0 else None)
            return RoundDraws(audit_sel=torch.stack([rr.audit_sel(i) for i in range(n)]),
                              audit_noise=noise)

        free = self.counted("no_off_lm", lambda: derailment.sweep(kl, kp, ko, kd, ke, grid,
                                                                   draws_fn=draws))
        args = dict(aggregator=spec.aggregator, agg_kwargs=spec.agg_kwargs, verify=spec.verify)
        cpu_round = tswarm.make_round_fn(cl, co, cp, n, **args)
        card_round = tswarm.make_round_fn(kl, ko, kp, n, **args)
        cpu_lanes, card_lanes = (tswarm.stack_lanes(spec.lanes, device=x)
                                 for x in (cpu, self.dev))
        finals = {"cpu": [], "card": []}
        slashed = {"cpu": [], "card": []}
        worst_agg = worst_loss = 0.0
        blown = {"agg_norm": [], "final loss": []}     # (rel, what) past blow-up
        t0 = time.time()
        for j in range(len(spec.lanes)):
            st = tswarm.init_state(cp, co, n)
            for r in range(rounds):
                kst = tswarm.tree_map(lambda x: x.to(self.dev), st)
                st, rec = cpu_round(cpu_lanes.lane(j), st, r, [cd(i, r) for i in range(n)])
                kst, krec = card_round(card_lanes.lane(j), kst, r, [kd(i, r) for i in range(n)],
                                       draws(j, r))
                for field in ("n_active", "caught", "keep"):
                    check(torch.equal(getattr(krec, field).cpu(), getattr(rec, field)),
                          f"lane {j} round {r}: {field} differs card vs CPU")
                a, b = float(krec.agg_norm), float(rec.agg_norm)
                check(math.isfinite(a) == math.isfinite(b), f"lane {j} round {r}: agg_norm")
                if math.isfinite(b):
                    rel = abs(a - b) / max(abs(b), 1e-30)
                    if b <= BLOWN_UP:
                        worst_agg = max(worst_agg, rel)
                        check(rel <= NO_OFF_LM_AGG_REL,
                              f"lane {j} round {r}: agg_norm {a} vs {b} (rel {rel:.3e})")
                    else:
                        blown["agg_norm"].append((rel, f"lane {j} round {r}: {a} vs {b}"))
            with torch.no_grad():
                finals["cpu"].append(float(ce(st.params)))
                finals["card"].append(float(ke(kst.params)))
            slashed["cpu"].append(st.slashed.numpy())
            slashed["card"].append(kst.slashed.cpu().numpy())
            x, y = finals["card"][-1], finals["cpu"][-1]
            check(math.isfinite(x) == math.isfinite(y), f"lane {j}: final loss finite on one side")
            if math.isfinite(y) and abs(y) <= BLOWN_UP_LOSS:
                worst_loss = max(worst_loss, abs(x - y) / abs(y))
                check(abs(x - y) <= NO_OFF_LM_LOSS_REL * abs(y),
                      f"lane {j}: final loss {x} vs {y}")
            elif math.isfinite(y):
                blown["final loss"].append((abs(x - y) / abs(y), f"lane {j}: {x} vs {y}"))
        init_loss = float(ce(cp))
        res = {k: derailment.SweepResult(
            grid=grid, results=derailment.sweep_results(spec, np.array(finals[k]),
                                                         np.stack(slashed[k]), init_loss),
            n_programs=1, n_runs=len(spec.lanes), wall_s=time.time() - t0) for k in finals}
        self.show_table("no_off_lm on the CPU", res["cpu"], rounds)
        check(res["card"].phase_table() == res["cpu"].phase_table(),
              "no_off_lm: the table of the card's rounds differs from the CPU's:\n"
              + res["card"].phase_table())
        print(f"  the card's rounds from the CPU's states: tables equal, discrete fields "
              f"equal, agg_norm within {worst_agg:.3e} until blow-up (bound "
              f"{NO_OFF_LM_AGG_REL:g}), final losses within {worst_loss:.3e} (bound "
              f"{NO_OFF_LM_LOSS_REL:g}) up to {BLOWN_UP_LOSS:g}; "
              f"{res['cpu'].wall_s:.1f} s for both", flush=True)
        for what, gaps in blown.items():
            worst = max(gaps, default=(0.0, "none"))
            print(f"  past blow-up: {len(gaps)} {what} readings, worst {worst[0]:.3e} "
                  f"relative ({worst[1]}; bound {NO_OFF_LM_BLOWN_REL:g})", flush=True)
        for what, gaps in blown.items():
            for rel, where in gaps:
                check(rel <= NO_OFF_LM_BLOWN_REL,
                      f"no_off_lm past blow-up: {what} {where} (rel {rel:.3e})")
        self.show_table("no_off_lm run free on the card", free, rounds)
        same = free.phase_table() == res["cpu"].phase_table()
        gaps = [abs(a.final_loss - b.final_loss) / abs(b.final_loss)
                for a, b in zip(free.results, res["cpu"].results)
                if math.isfinite(a.final_loss) and math.isfinite(b.final_loss)]
        print(f"  free card run against the CPU run: tables {'equal' if same else 'differ'}, "
              f"verdicts differing in {sum(a.derailed != b.derailed for a, b in zip(free.results, res['cpu'].results))} "
              f"of {len(free.results)} cells, finite final losses within "
              f"{max(gaps, default=0.0):.3e} relative; init loss {init_loss:.6f}", flush=True)
        check(all(math.isfinite(r.baseline_loss) for r in free.results),
              "no_off_lm: non-finite baseline on the card")

    def no_off_topology(self):
        """Phase 10d: the ``no_off_topology_smoke`` sweep (CenteredClip on a
        ring and on the complete graph, 2 and 6 attackers beside 6 honest,
        8 rounds; the decentralized round) on the tiny quadratic, on the
        card (each node's neighbourhood through the median and the chain,
        on counters of its own: one CenteredClip round for each lane, round
        and node with a kept neighbour) and on the CPU, tables and cells
        held as phase 10's."""
        from repro_torch.core import derailment, scenarios
        from repro_torch.launch import problems
        grid = scenarios.get_sweep_grid("no_off_topology_smoke")
        spec = derailment.build_sweep_lanes(grid)
        rounds_cc = 0
        for lane, meta in zip(spec.lanes, spec.metas):
            if meta[0] is not None and meta[0].aggregator == "centered_clip":
                for r in range(grid.rounds):
                    active = (lane.joins <= r) & (r < lane.leaves)
                    rounds_cc += int(((lane.mixing > 0) & active[None, :]).any(1).sum())
        EXPECTED_LAUNCHES["no_off_topology_smoke"] = {
            k: rounds_cc * v for k, v in _CC_ROUND.items()}
        n_cc = sum(m[0] is not None for m in spec.metas)
        print(f"  no_off_topology_smoke: {rounds_cc} of the {n_cc * spec.n_total * grid.rounds} "
              "node-rounds of its CenteredClip lanes aggregate a kept neighbourhood", flush=True)

        def run(device):
            loss_fn, params, data_fn, eval_fn, opt = problems.tiny_quadratic_problem(
                device=device)
            return derailment.sweep(loss_fn, params, opt, data_fn, eval_fn, grid)

        card = self.counted("no_off_topology_smoke", lambda: run("cuda"))
        self.hold_tables("no_off_topology_smoke (tiny quadratic, 16 params)", card,
                         run("cpu"), NO_OFF_LOSS_REL)

    def campaign_full_width(self, problem):
        """Phase 10b: ``no_off_smoke`` as one campaign at protocol-125m's
        full width (the showcase's problem and AdamW at 5e-3, a global
        batch of 2N), rounds cut to NO_OFF_ROUNDS_125M; two of its lanes
        bit-equal to the single-run Swarm that ``simulate_derailment``
        builds for the same cell on the sweep's baseline.  Then each lane
        run alone and its rounds timed (``lane_rounds``), and the
        CenteredClip Swarm's busy share (``busy_share``)."""
        torch = self.torch
        from repro_torch.core import derailment, scenarios
        from repro_torch.data.pipeline import model_batch
        from repro_torch.optim.optimizer import AdamW
        grid = scenarios.get_sweep_grid("no_off_smoke")
        n = grid.n_honest + max(grid.attacker_counts)
        data_fn = problem.data_fn(n)
        eval_batch = model_batch(problem.cfg, problem.data_cfg(n), 10**6,
                                 device=problem.device)

        def eval_fn(params):
            return problem.loss_fn(params, eval_batch)

        args = (problem.loss_fn, problem.params, AdamW(lr=5e-3), data_fn, eval_fn)
        print(f"  no_off_smoke_125m: {grid.n_lanes} lanes of N = {n} (a ({n}, {D_FULL:,}) "
              f"float32 stack, {n * D_FULL * 4 / 1e9:.1f} GB, a lane-round); rounds cut "
              f"from {grid.rounds} to {NO_OFF_ROUNDS_125M}", flush=True)
        cells = {("mean", 2), ("centered_clip", 6)}
        held = {}

        def body():
            t0 = time.time()
            res, campaign = derailment.sweep(*args, grid, rounds=NO_OFF_ROUNDS_125M,
                                             return_campaign=True)
            torch.cuda.synchronize()
            held["sweep_s"] = time.time() - t0
            held["peak"] = torch.cuda.max_memory_allocated()
            held["campaign"] = campaign
            for j, r in enumerate(res.results):
                if (r.aggregator, r.n_attackers) in cells:
                    t0 = time.time()
                    single, sw = derailment.simulate_derailment(
                        *args, n_honest=grid.n_honest, n_attack=r.n_attackers,
                        rounds=NO_OFF_ROUNDS_125M, aggregator=r.aggregator, seed=r.seed,
                        baseline_loss=r.baseline_loss, return_swarm=True)
                    torch.cuda.synchronize()
                    print(f"  simulate_derailment({r.aggregator}, {r.n_attackers} attackers): "
                          f"{time.time() - t0:.3f} s ({NO_OFF_ROUNDS_125M} rounds, "
                          f"{NO_OFF_ROUNDS_125M + 1} evals)", flush=True)
                    self.lane_vs_swarm(campaign, j, r, single, sw)
                    held["swarm"] = sw
            return res

        res = self.counted("no_off_smoke_125m", body)
        print("  no_off_smoke_125m phase table (2 rounds):\n"
              + "\n".join("    " + line for line in res.phase_table().splitlines()), flush=True)
        check(all(math.isfinite(r.final_loss) and math.isfinite(r.baseline_loss)
                  for r in res.results), "non-finite loss at full width")
        print(f"  no_off_smoke_125m: sweep {held['sweep_s']:.3f} s on the host clock "
              f"(set-up, {res.n_runs} lanes x {NO_OFF_ROUNDS_125M} rounds and "
              f"{res.n_runs + 1} evals); max_memory_allocated {held['peak'] / 2**30:.2f} GiB "
              "(sweep)", flush=True)
        self.lane_rounds(args, grid, n, held.pop("campaign"))
        self.busy_share(held.pop("swarm"), n)
        torch.cuda.reset_peak_memory_stats()
        again = derailment.sweep(*args, grid, rounds=NO_OFF_ROUNDS_125M)
        peak = torch.cuda.max_memory_allocated()
        check(again.phase_table() == res.phase_table()
              and [r.final_loss for r in again.results] == [r.final_loss for r in res.results],
              "the sweep without its campaign's outputs differs from the one with them")
        print(f"  no_off_smoke_125m without return_campaign (no lane's params kept): "
              f"max_memory_allocated {peak / 2**30:.2f} GiB; table and final losses "
              "equal to the first sweep's", flush=True)

    def lane_rounds(self, args, grid, n, campaign):
        """Every lane of the 10b campaign run alone by ``make_scan_program``
        (no eval) from the batches the sweep saw, made before the clock
        starts: its records and final params bit-equal to the campaign's
        lane, and each round timed with CUDA events (an event recorded as
        the loop asks for the round's batches, one after the loop)."""
        torch = self.torch
        from repro_torch.core import derailment
        from repro_torch.core import swarm as tswarm
        loss_fn, params0, opt, data_fn, _ = args
        spec = derailment.build_sweep_lanes(grid)
        lanes = tswarm.stack_lanes(spec.lanes, device=self.dev)
        round_fn = tswarm.make_round_fn(loss_fn, opt, params0, n, aggregator=spec.aggregator,
                                        agg_kwargs=spec.agg_kwargs, verify=spec.verify)
        batches = [[data_fn(i, r) for i in range(n)] for r in range(NO_OFF_ROUNDS_125M)]
        state, recs, _ = campaign
        times = []
        for k in range(lanes.n_lanes):
            marks = []

            def batch_fn(r):
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
                return batches[r]

            run = tswarm.make_scan_program(round_fn, batch_fn, NO_OFF_ROUNDS_125M)
            one_state, one_recs, _ = run(lanes.lane(k), *tswarm.init_state(params0, opt, n))
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            times.append(ms)
            for field in tswarm.RoundRecord._fields:
                a, b = getattr(tswarm.lane_slice(recs, k), field), getattr(one_recs, field)
                if a is None or b is None:       # a field of an axis not in the run
                    check(a is b, f"lane {k}: RoundRecord.{field} is None on one side")
                    continue
                check(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                  b.view(torch.int32) if b.dtype == torch.float32 else b),
                      f"lane {k}: RoundRecord.{field} differs campaign vs scan program")
            for name, p in one_state.params.items():
                bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
                check(torch.equal(state.params[name][k].view(bits), p.view(bits)),
                      f"lane {k}: params[{name}] differ campaign vs scan program")
            agg = spec.agg_specs[spec.lanes[k].agg_id][0]
            print(f"  lane {k} ({agg}) alone: rounds {[round(x, 1) for x in ms]} ms on CUDA "
                  "events; records and params bit-equal to the campaign's lane", flush=True)
            del one_state, one_recs, run
        flat = sorted(x for ms in times for x in ms)
        med = statistics.median(flat)
        print(f"  s per lane-round: median {med / 1e3:.4f} s over {len(flat)} lane-rounds, "
              f"min {flat[0] / 1e3:.4f}, max {flat[-1] / 1e3:.4f} (CUDA events around each "
              "round of the scan loop; set-up and evals excluded)", flush=True)

    def busy_share(self, sw, n):
        """Three more rounds of the CenteredClip cell's Swarm (N = ``n``)
        timed with CUDA events, then one under torch.profiler: the device's
        busy share of the median unprofiled round."""
        torch = self.torch
        ms = []
        for r in range(NO_OFF_ROUNDS_125M, NO_OFF_ROUNDS_125M + 3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            sw.step(r)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        med = statistics.median(ms)
        t0 = time.time()
        wall_ms, events, busy_ms = self.profiled_round(sw, NO_OFF_ROUNDS_125M + 3)
        print(f"  the profiled lane-round took {time.time() - t0:.1f} s with the "
              "profiler's own processing", flush=True)
        share = f"{busy_ms / med:.1%}" if busy_ms > 0 else "not measured"
        print(f"  a lane-round (centered_clip, N = {n}): unprofiled {[round(x, 1) for x in ms]} "
              f"ms on CUDA events, median {med:.1f} (spread {max(ms) - min(ms):.1f}); profiled "
              f"{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms = {share} of the median "
              "round", flush=True)

    def lane_vs_swarm(self, campaign, j, r, single, sw):
        """Lane ``j`` of a sweep's campaign against the single-run Swarm of
        its cell (N = 6 + count rows; the lane's padding rows beyond them
        never join): params, slashed and contrib bit-equal, the history
        equal (every RoundRecord field but ``keep``, read to the host as
        the Swarm reads it), each node's kept rounds its contrib, the final
        loss equal."""
        torch = self.torch
        from repro_torch.core import swarm as tswarm
        state, recs, final = campaign
        m = len(sw.nodes)
        what = f"{r.aggregator} with {r.n_attackers} attackers"
        for k, p in sw.params.items():
            bits = torch.int16 if p.dtype == torch.bfloat16 else torch.int32
            check(torch.equal(state.params[k][j].view(bits), p.view(bits)),
                  f"{what}: params[{k}] differ lane vs Swarm")
        slashed = torch.tensor([x.node_id in sw.slashed for x in sw.nodes], device=self.dev)
        kept = recs.keep[j].float().sum(0)
        for name, lane, one in (("slashed", state.slashed[j], slashed),
                                ("contrib", state.contrib[j], sw.contrib),
                                ("kept rounds", kept, sw.contrib)):
            check(torch.equal(lane[:m], one) and not lane[m:].any(),
                  f"{what}: {name} differs lane vs Swarm")
        ids = [x.node_id for x in sw.nodes] + [f"pad{i}" for i in range(m, len(kept))]
        history = [{k: v for k, v in row.items() if k != "eval_loss"} for row in sw.history]
        check(tswarm.history_from_records(tswarm.lane_slice(recs, j), ids) == history,
              f"{what}: history differs lane vs Swarm")
        check(float(final[j]) == single.final_loss == r.final_loss,
              f"{what}: final loss {float(final[j])} vs Swarm {single.final_loss}")
        print(f"  lane {j} ({what}, N = {state.slashed.shape[1]}) bit-equal to its "
              f"single-run Swarm (N = {m}): params, slashed, contrib, kept rounds, "
              f"history; final loss {r.final_loss:.6f}", flush=True)

    def profiled_round(self, sw, r):
        """Round ``r`` of ``sw`` under torch.profiler: its wall ms (profiler
        on), its device-side events (kernels, memcpy, memset; the aten::
        rows repeat their kernels' time) and their summed device ms."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sw.step(r)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        return wall_ms, events, sum(self_dev(e) for e in events)

    def profile_rounds(self, sw, cc_kernel):
        """Two more showcase rounds of ``sw`` timed on the host clock, then
        one under torch.profiler: device time by kernel and the device's
        busy share.  The round's CenteredClip chain (``cc_kernel``'s row)
        is held to 1 + 2 x CC_ITERS launches: one norm pass, then a
        finalize and an apply pass an iteration; the mean device ms of each
        kind is kept for its phase 9 row."""
        torch = self.torch
        times = []
        for r in (3, 4):
            t0 = time.time()
            sw.step(r)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        print(f"  showcase round wall times (no profiler): {times} s", flush=True)
        wall_ms, events, busy_ms = self.profiled_round(sw, 5)
        if busy_ms <= 0:
            print("  profiler: no device time recorded (device busy share not "
                  "measured)", flush=True)
            return
        plain_ms = 1e3 * sorted(times)[0]
        print(f"  profiled round: {wall_ms:.1f} ms wall with the profiler on; device "
              f"busy {busy_ms:.1f} ms = {busy_ms / plain_ms:.1%} of the faster "
              f"unprofiled round ({plain_ms:.1f} ms)", flush=True)
        for e in sorted(events, key=self_dev, reverse=True)[:14]:
            print(f"    {self_dev(e):9.2f} ms  x{e.count:<5d} {e.key[:90]}", flush=True)
        kinds = {"(a) cc_norm_pass": ("cc_norm_pass<",),
                 "(b) finalize": ("cc_finalize<", "cc_dense_finalize<"),
                 "(c) cc_apply_pass": ("cc_apply_pass<",)}
        ms, count = {k: 0.0 for k in kinds}, {k: 0 for k in kinds}
        for e in events:
            for kind, parts in kinds.items():
                if any(part in e.key for part in parts):
                    ms[kind] += self_dev(e)
                    count[kind] += e.count
        print(f"    {cc_kernel} chain by launch kind: " + ", ".join(
            f"{k} x{count[k]} {ms[k] / max(count[k], 1):.3f} ms" for k in kinds), flush=True)
        want = dict(zip(kinds, (1, CC_ITERS, CC_ITERS)))
        check(count == want, f"{cc_kernel}: chain launches {count}, expected {want}")
        self.scan_split[cc_kernel] = {k: ms[k] / count[k] for k in kinds}

    def protocol_serve(self):
        """The serving path at full width, on counters of its own; returns
        the launcher's results and the decode's prompts for phases 7b and 8."""
        torch = self.torch
        from repro_torch.launch import protocol_inference as launch
        from repro_torch.models.attention import cache_length

        def drive():
            out = launch.main(["--arch", "h2o-danube-1.8b", "--full", "--seq",
                               str(SWA_SHAPE["s"]), "--batch", str(SWA_SHAPE["b"])])
            g = torch.Generator(device=self.dev).manual_seed(5)
            prompts = torch.randint(0, out["model"].cfg.vocab_size,
                                    (DECODE_PROMPTS, DECODE_LEN), generator=g,
                                    device=self.dev)
            gen, stats = out["server"].decode("customer", prompts[:, :SERVE_DECODE_LEN],
                                              DECODE_NEW)
            return out, prompts, gen, stats

        out, prompts, gen, stats = self.counted("protocol_serve", drive)
        out["prompts"] = prompts
        cfg = out["model"].cfg
        check(cfg.use_pallas_kernels and cfg.sliding_window == SWA_SHAPE["window"]
              and cfg.param_count() == 1_831_201_280, "not full-width h2o-danube-1.8b")
        self.check_served(out, gen)
        self.profile_decode_step(out)
        self.decode_rate = (stats.tok_per_s, 1e3 * stats.decode_s / DECODE_NEW)
        print(f"  protocol_serve: prefill of {SWA_SHAPE['b']} x {SWA_SHAPE['s']} tokens "
              f"{out['prefill_s']:.3f} s; decode {DECODE_PROMPTS} x {SERVE_DECODE_LEN} -> "
              f"{DECODE_NEW} new: {stats.tok_per_s:.1f} tok/s (prefill by stepping "
              f"{stats.prefill_s:.3f} s, decode {stats.decode_s:.3f} s); coalition "
              f"logits relative L2 {out['extract_rel']:.3f}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        del out["server"]
        return out

    def check_served(self, out, gen, new=DECODE_NEW):
        """Phase 7's checks on a served path: refused without credentials;
        served logits finite and bit-equal to ``Model.prefill(params)``
        with the full swarm and with node3 offline; a swarm of 2 nodes
        refused naming the missing shards; a 3-node coalition's logits far
        from the true ones; the decode on params equal to the true ones,
        giving tokens in the vocabulary."""
        torch = self.torch
        from repro_torch.core.protocol import CredentialError, ExtractionError
        from repro_torch.launch import protocol_inference as launch
        cfg = out["model"].cfg
        check(isinstance(out["refused"], CredentialError), "served without credentials")
        logits, ref = out["logits"], out["ref"]
        check(tuple(logits.shape) == (out["batch"]["tokens"].shape[0], cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), "served logits not finite or misshapen")
        check(torch.equal(logits, ref), "served logits not bit-equal to Model.prefill(params)")
        check(torch.equal(out["logits_online"], ref),
              "logits with node3 offline not bit-equal to Model.prefill(params)")
        check(isinstance(out["collapsed"], ExtractionError)
              and "missing shard ids" in str(out["collapsed"]),
              "a swarm of 2 nodes served, or did not name the missing shards")
        check(out["extract_rel"] > 0.1, f"a 3-node coalition's logits are close to the "
                                        f"true ones (relative L2 {out['extract_rel']:.3e})")
        served = out["server"]._params_cache[frozenset(launch.NODES)]
        check(all(torch.equal(served[k], t) for k, t in out["params"].items()),
              "the params the server decoded with differ from the true ones")
        check(tuple(gen.shape) == (DECODE_PROMPTS, new)
              and bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
              "decode tokens misshapen or outside the vocabulary")

    def profile_decode_step(self, out):
        """One decode step at the decode phase's shape under torch.profiler:
        kernels launched, device time, host time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        model, params = out["model"], out["params"]
        tok = torch.zeros((DECODE_PROMPTS, 1), dtype=torch.long, device=self.dev)
        with torch.inference_mode():
            cache = model.init_cache(DECODE_PROMPTS, DECODE_LEN + DECODE_NEW, self.dev)
            for _ in range(2):
                _, cache = model.decode_step(params, tok, cache)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.decode_step(params, tok, cache)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(self_dev(e) for e in events)
        launches = sum(e.count for e in events)
        print(f"  one decode step ({DECODE_PROMPTS} sequences, profiled): {launches} device "
              f"ops, {dev_ms:.2f} ms of device time in {host_ms:.2f} ms", flush=True)

    def rel(self, a, b):
        """Relative L2 of ``a`` against ``b``, in float32."""
        return float((a.float() - b.float()).norm() / b.float().norm())

    def last_logits(self, params, cfg, h):
        """The logits (B, V) of the last position of hidden states h."""
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm
        h = rms_norm(h, params["ln_f"], cfg.norm_eps)[:, -1].float()
        return self.torch.einsum("bd,dv->bv", h, T.unembed_of(params).float())

    def decode_vs_prefill(self, out):
        """The ring-buffer decode against the kernel prefill, teacher-forced
        across the wrap, on phase 7's prompts.  For each layer the ring is
        filled here (at slot pos % 4096, not by ``cache_insert``) with the
        keys and values of the positions before the last WRAP_STEPS,
        computed from the prefill's input to the layer; then
        ``layer_decode`` steps the last WRAP_STEPS positions, each from the
        prefill's input at that position: 64 fill the ring's last slots and
        64 overwrite its first.  Free-running the random model is chaotic
        (phase 8), so each layer is held on its own."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.models import transformer as T
        from repro_torch.models.attention import cache_length
        from repro_torch.models.common import rms_norm
        model, params, prompts = out["model"], out["params"], out["prompts"]
        cfg = model.cfg
        b, s = prompts.shape
        lc = cache_length(s, cfg.sliding_window)
        start = s - WRAP_STEPS
        check(cache_length(DECODE_LEN + DECODE_NEW, cfg.sliding_window) < DECODE_LEN,
              "the prompts do not wrap the ring")
        check(start < lc < s, "the stepped positions do not cross the ring's wrap")
        positions = torch.arange(s, device=self.dev).expand(b, s)
        slots = torch.arange(start, device=self.dev) % lc
        before, after = [], []            # per layer: positions < lc, >= lc
        with torch.inference_mode():
            cache = model.init_cache(b, s, self.dev)
            x = F.embedding(prompts, params["embed"])
            for i, lp in enumerate(T._per_layer(params, cfg)):
                y = T._layer_apply(lp, cfg, x, positions)           # the kernel prefill
                h = rms_norm(x[:, :start], lp["ln_attn"], cfg.norm_eps)
                _, k, v = T._qkv(lp, cfg, h, positions[:, :start])
                kc, vc = cache["k"][i], cache["v"][i]
                kc[:, slots], vc[:, slots] = k, v
                stepped = torch.cat([T.layer_decode(lp, cfg, x[:, t:t + 1], kc, vc, t)
                                     for t in range(start, s)], dim=1)
                base, want = x[:, start:].float(), y[:, start:].float()
                got, cut = stepped.float() - base, lc - start
                before.append(self.rel(got[:, :cut], want[:, :cut] - base[:, :cut]))
                after.append(self.rel(got[:, cut:], want[:, cut:] - base[:, cut:]))
                x = y
            gap = self.rel(self.last_logits(params, cfg, stepped),
                           self.last_logits(params, cfg, x))
        print(f"  decode vs prefill, teacher-forced over positions {start}-{s - 1} "
              f"(ring of {lc}): layer updates within {max(before):.3e} relative L2 "
              f"before the wrap and {max(after):.3e} after it (worst of {len(after)} "
              f"layers), last position's logits {gap:.3e}", flush=True)
        check(max(before + after) <= 1e-2 and gap <= 1e-2,
              f"decode and prefill differ beyond 1e-2 (layers {max(before + after):.3e}, "
              f"logits {gap:.3e})")

    def swa_route_gap(self, out):
        """The served prefill's kernel route against the ``_swa`` route
        (``use_pallas_kernels`` off: float32 per q block).  Held teacher-
        forced: at each of the 24 layers both routes take the kernel route's
        input, and the layer's update and the last layer's logits must agree
        within 1e-2 relative L2.  Free-running, the random model is chaotic
        (the reference's init gives q.k scores of std ~60), so any two float
        orders part after a few layers.  A third route without the kernel,
        ``swa_attention_plain`` in its place, measures that: the kernel
        route's free-running gap to ``_swa`` is held to at most twice the
        gap between the two routes without it."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.core.serving import device_clock
        from repro_torch.kernels.swa_attention import ops as swa
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as T
        from repro_torch.models.model import build_model

        cfg_k = out["model"].cfg
        cfg_s = replace(cfg_k, use_pallas_kernels=False)
        params, tokens = out["params"], out["batch"]["tokens"]
        kernel_entry = A.swa_attention

        def plain_layer(lp, h):                   # swa_attention_plain for the kernel
            A.swa_attention = swa.swa_attention_plain
            try:
                return T._layer_apply(lp, cfg_k, h, positions)
            finally:
                A.swa_attention = kernel_entry

        with torch.inference_mode():
            t0 = device_clock(self.dev)
            free = build_model(cfg_s).prefill(params, out["batch"])
            dt = device_clock(self.dev) - t0
            x = y = z = F.embedding(tokens, params["embed"])
            positions = torch.arange(tokens.shape[1], device=self.dev).expand(tokens.shape)
            gaps, free_gaps, witness_gaps = [], [], []
            for lp in T._per_layer(params, cfg_k):
                a = T._layer_apply(lp, cfg_k, x, positions)
                b = T._layer_apply(lp, cfg_s, x, positions)
                y = T._layer_apply(lp, cfg_s, y, positions)     # the _swa route, free
                z = plain_layer(lp, z)                          # the plain route, free
                gaps.append(self.rel(a.float() - x.float(), b.float() - x.float()))
                free_gaps.append(self.rel(a, y))
                witness_gaps.append(self.rel(z, y))
                x = a
            la, lb = (self.last_logits(params, cfg_k, h) for h in (a, b))
            free_kernel = self.rel(out["ref"], free)
            free_witness = self.rel(self.last_logits(params, cfg_k, z), free)
        gap = self.rel(la, lb)
        print(f"  kernel route vs _swa route, teacher-forced: layer updates within "
              f"{max(gaps):.3e} relative L2 (worst of {len(gaps)} layers), logits "
              f"{gap:.3e}; the kernel route's logits equal the served ones: "
              f"{bool(torch.equal(la, out['ref']))}", flush=True)
        print(f"  free-running: kernel vs _swa logits {free_kernel:.3e}, hidden states "
              f"after each layer {[float(f'{g:.2e}') for g in free_gaps]}", flush=True)
        print(f"  free-running, no kernel on either side: swa_attention_plain vs _swa "
              f"logits {free_witness:.3e}, hidden states after each layer "
              f"{[float(f'{g:.2e}') for g in witness_gaps]}; _swa prefill {dt:.3f} s "
              f"vs kernel route {out['prefill_s']:.3f} s", flush=True)
        check(max(gaps) <= 1e-2 and gap <= 1e-2,
              f"kernel and _swa routes differ beyond 1e-2 (layers {max(gaps):.3e}, "
              f"logits {gap:.3e})")
        check(free_kernel <= max(1e-2, 2 * free_witness),
              f"free-running, the kernel route parts from _swa ({free_kernel:.3e}) more "
              f"than twice as far as two routes without the kernel ({free_witness:.3e})")

    def serving_engine(self):
        """Phase 7g: the continuous-batching engine at full width.  The
        launcher's run on counters of its own (no kernel: prefill steps
        ``decode_step``); then one custody-gated ``ServingEngine.run`` on
        the same model and prompts, and the same lane stepped by hand with
        ``make_serve_step`` under ``torch.cuda.set_sync_debug_mode("error")``
        (any host sync inside a step raises), equal to the run field for
        field; the records equal to the same lane's on the CPU with the
        reduced model (no EOS, so the schedule is the lane's alone), the
        coverage trace to numpy's; at mid-horizon, layers 0 and 1 of each
        occupied slot's K/V against the request stepped alone (B = 1)."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import serving
        from repro_torch.core.swarm import stack_trees
        from repro_torch.core.unextractable import assign_matrix
        from repro_torch.launch import serve as launch
        from repro_torch.models import transformer as T

        args = ENGINE_ARGS
        out = self.counted("serving_engine", lambda: launch.main([
            "--driver", "engine", "--arch", "h2o-danube-1.8b", "--full",
            "--batch", str(args["batch"]), "--slots", str(args["slots"]),
            "--prompt-len", str(args["prompt_len"]), "--max-new", str(args["max_new"])]))
        model, params, prompts, first = out["model"], out["params"], out["prompts"], out["result"]
        cfg, n, steps = model.cfg, args["batch"], ENGINE_STEPS
        check(sum(t.numel() for t in params.values()) == 1_831_201_280
              and cfg.sliding_window == SWA_SHAPE["window"], "not full-width h2o-danube-1.8b")
        check(bool(first.done.all()) and first.tokens_served == n * args["max_new"],
              f"the launcher's engine served {int(first.done.sum())} of {n} requests")

        # the custody-gated lane
        c = ENGINE_CUSTODY
        custody = assign_matrix(c["n_nodes"], c["num_shards"], c["redundancy"], seed=0,
                                max_fraction=c["max_fraction"])
        rng = np.random.default_rng(11)
        plens = rng.integers(args["prompt_len"] // 2, args["prompt_len"] + 1, n)
        budgets = rng.integers(4, args["max_new"] + 1, n)
        down_from = np.full(c["n_nodes"], np.iinfo(np.int32).max, np.int64)
        down_until = down_from.copy()
        holders0 = np.flatnonzero(custody[:, 0])
        down_from[holders0], down_until[holders0] = ENGINE_OUTAGE
        scfg = serving.ServingConfig(slots=args["slots"], max_new=args["max_new"], steps=steps)

        def lane_on(dev):
            return serving.build_lane(
                n_requests=n, prompt_lens=plens, max_new=budgets, steps=steps,
                n_nodes=c["n_nodes"], balances=[100.0] * 4, fee=1.0, load=1.0,
                custody=custody, device=dev)._replace(
                node_down_from=torch.from_numpy(down_from).to(dev),
                node_down_until=torch.from_numpy(down_until).to(dev))

        lane = lane_on(self.dev)
        engine = serving.ServingEngine(model, scfg, prompts)
        res = self.counted("serving_engine", lambda: engine.run(params, lane))

        # the same lane stepped by hand, no host sync allowed inside a step
        step, init_state = serving.make_serve_step(model, scfg, tuple(prompts.shape),
                                                   has_custody=True)
        mid = steps // 2
        with torch.inference_mode():
            ts = torch.arange(steps, device=self.dev)
            state, recs = init_state(lane), []
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for i in range(steps):
                    state, rec = step(params, prompts, lane, state, ts[i])
                    recs.append(rec)
                    if i == mid - 1:
                        snap = dict(k=state.caches["k"][:2].clone(),
                                    v=state.caches["v"][:2].clone(),
                                    slot_req=state.slot_req.clone(),
                                    slot_t=state.slot_t.clone(),
                                    out=state.out_tokens.clone())
            finally:
                torch.cuda.set_sync_debug_mode(0)
            by_hand = serving._result_from_device(state, stack_trees(recs))
        fields = ("tokens", "done", "admitted", "balances", "coverage", "live", "n_active",
                  "n_admitted", "new_tokens", "queued")
        for f in fields:
            check(np.array_equal(getattr(by_hand, f), getattr(res, f)),
                  f"7g: the hand-stepped lane's {f} differs from ServingEngine.run's")

        # the schedule is the lane's alone: the reduced model on the CPU
        small = launch.serving_config("h2o-danube-1.8b", False)
        from repro_torch.models.model import build_model
        small_model = build_model(small)
        cpu = serving.ServingEngine(small_model, scfg, prompts.cpu() % small.vocab_size,
                                    device="cpu").run(small_model.init(0, "cpu"),
                                                      lane_on(torch.device("cpu")))
        for f in fields[4:] + ("done", "admitted", "balances"):
            check(np.array_equal(getattr(cpu, f), getattr(res, f)),
                  f"7g: {f} differs from the same lane's on the CPU")

        # availability: numpy's coverage; dead steps exactly the outage's
        online = ~((down_from[None, :] <= np.arange(steps)[:, None])
                   & (np.arange(steps)[:, None] < down_until[None, :]))
        want_cov = np.array([np.mean(np.any(custody & o[:, None], axis=0).astype(np.float32))
                             for o in online], np.float32)
        lo, hi = ENGINE_OUTAGE
        dead = ~res.live
        check(np.array_equal(res.coverage, want_cov), "7g: coverage differs from numpy's")
        check(dead[lo:hi].all() and not dead[:lo].any() and not dead[hi:].any(),
              f"7g: dead steps {np.flatnonzero(dead).tolist()}, expected [{lo}, {hi})")
        check(not res.n_admitted[dead].any() and not res.new_tokens[dead].any(),
              "7g: a dead step admitted a request or delivered a token")
        check(res.new_tokens[hi:].sum() > 0 and bool(res.done.all()),
              f"7g: serving did not resume and finish ({int(res.done.sum())} of {n} done)")

        # mid-horizon K/V of layers 0 and 1 against each request stepped alone
        worst, rows = 0.0, 0
        layers = T._per_layer(params, cfg)[:2]
        held, given = prompts.cpu(), snap["out"].cpu()
        with torch.inference_mode():
            for slot in range(args["slots"]):
                r, fed = int(snap["slot_req"][slot]), int(snap["slot_t"][slot])
                if r >= n or fed == 0:
                    continue
                toks = [int(held[r, t]) if t < plens[r] else int(given[r, t - plens[r]])
                        for t in range(fed)]
                kc = torch.zeros_like(snap["k"][:, :1])
                vc = torch.zeros_like(kc)
                for t, tok in enumerate(toks):
                    x = torch.nn.functional.embedding(
                        torch.tensor([[tok]], device=self.dev), params["embed"])
                    for li, lp in enumerate(layers):
                        x = T.layer_decode(lp, cfg, x, kc[li], vc[li], t)
                for li in range(2):
                    for name, alone in (("k", kc), ("v", vc)):
                        want = alone[li, 0, :fed]
                        check(bool(want.float().norm() > 0), f"7g: request {r}'s {name} is 0")
                        worst = max(worst, self.rel(snap[name][li, slot, :fed], want))
                rows += 1
        check(rows > 0, "7g: no slot was occupied at mid-horizon")
        per_step = 1e3 * res.wall_s / steps
        rate, decode_ms = getattr(self, "decode_rate", (float("nan"), float("nan")))
        print(f"  engine, custody-gated ({n} requests, prompts {plens.min()}-{plens.max()}, "
              f"budgets {budgets.min()}-{budgets.max()}, {args['slots']} slots, {steps} "
              f"steps): all done, dead steps exactly [{lo}, {hi}) (coverage "
              f"{float(res.coverage[lo]):.4f}), no host sync in {steps} hand-stepped "
              f"steps, records equal to the CPU's; layers 0-1 K/V of {rows} slots at step "
              f"{mid} within {worst:.3e} relative L2 of B = 1 (bound {ENGINE_KV_REL})",
              flush=True)
        print(f"  engine rate: launcher {first.tok_per_s:.1f} tok/s, "
              f"{1e3 * first.wall_s / out['engine'].cfg.steps:.2f} ms a step ({args['slots']} "
              f"slots); custody-gated run {res.tok_per_s:.1f} tok/s, {per_step:.2f} ms a step; "
              f"phase 7's greedy decode ({DECODE_PROMPTS} sequences) {rate:.1f} tok/s, "
              f"{decode_ms:.2f} ms a step", flush=True)
        check(worst <= ENGINE_KV_REL, f"7g: K/V of layers 0-1 {worst:.3e} from B = 1")

    def serving_smoke(self):
        """Phase 10h: ``serving.sweep`` of ``serving_smoke`` on the reduced
        protocol-125m of ``launch/serving_no_off.py`` (float32), card
        against CPU: tables equal as strings, cells equal; one of its lanes
        through ``ServingEngine.run`` on both, tokens and records equal.
        Then the reduced windowed danube, rwkv6 and zamba2 engines (float32)
        on the lane of ``tests/test_torch_serving_families.py``, card
        against CPU, tokens and records equal."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core import serving
        from repro_torch.core.scenarios import get_serving_grid
        from repro_torch.core.unextractable import assign_matrix
        from repro_torch.launch.serving_no_off import MODEL
        from repro_torch.models.model import build_model
        cpu = torch.device("cpu")

        def on(params, dev):
            return {k: t.to(dev) for k, t in params.items()}

        def both(model, params, cfg, prompts, lane_kwargs, replace=None):
            out = []
            for dev in (self.dev, cpu):
                lane = serving.build_lane(**lane_kwargs, device=dev)._replace(
                    **{k: torch.from_numpy(v).to(dev) for k, v in (replace or {}).items()})
                out.append(serving.ServingEngine(model, cfg, prompts, device=dev).run(
                    on(params, dev), lane))
            for f in ("tokens", "done", "admitted", "balances", "coverage", "live",
                      "n_active", "n_admitted", "new_tokens", "queued"):
                check(np.array_equal(getattr(out[0], f), getattr(out[1], f)),
                      f"10h {model.cfg.name}: {f} differs card vs CPU")
            return out[0]

        model = build_model(get_config("protocol-125m").reduced(**MODEL))
        params = model.init(0, cpu)
        grid = get_serving_grid("serving_smoke")
        card = self.counted("serving_smoke",
                            lambda: serving.sweep(model, on(params, self.dev), grid))
        host = serving.sweep(model, params, grid, device="cpu")
        check(card.availability_table() == host.availability_table(),
              "10h: serving_smoke tables differ card vs CPU")
        check([dataclasses.astuple(x) for x in card.cells]
              == [dataclasses.astuple(x) for x in host.cells], "10h: cells differ")
        print(card.availability_table(), flush=True)
        prompts = torch.randint(0, model.cfg.vocab_size, (grid.n_requests, grid.prompt_len),
                                generator=torch.Generator().manual_seed(0))
        p = grid.prompt_len
        both(model, params, serving.ServingConfig(slots=grid.slots, max_new=grid.max_new,
                                                  steps=grid.steps), prompts,
             dict(n_requests=grid.n_requests,
                  prompt_lens=(p // 2 + np.arange(grid.n_requests) % (p - p // 2 + 1)),
                  max_new=grid.max_new, steps=grid.steps, n_nodes=grid.n_nodes,
                  balances=[grid.fee * grid.n_requests + 1.0] * grid.n_holders,
                  fee=grid.fee, load=1.5, churn_rate=0.6, seed=0,
                  custody=assign_matrix(grid.n_nodes, grid.num_shards, 2, seed=0,
                                        max_fraction=grid.max_fraction)))
        served = {}
        cfg = serving.ServingConfig(slots=3, max_new=5, steps=40)
        down_from = np.full(4, np.iinfo(np.int32).max, np.int64)
        down_until = down_from.copy()
        down_from[0], down_until[0] = 10, 16
        for arch, kw in ENGINE_FAMILIES.items():
            fam = build_model(get_config(arch).reduced(**kw))
            prompts = np.random.default_rng(7).integers(0, fam.cfg.vocab_size, (6, 6))
            res = both(fam, fam.init(0, cpu), cfg, prompts, dict(
                n_requests=6, prompt_lens=[6, 3, 5, 6, 4, 6], max_new=[5, 5, 2, 4, 5, 3],
                steps=cfg.steps, n_nodes=4, balances=[100.0, 100.0], fee=1.0,
                arrivals=[0, 0, 1, 3, 3, 9],
                custody=assign_matrix(4, 8, redundancy=1, seed=0, max_fraction=0.5)),
                replace=dict(node_down_from=down_from, node_down_until=down_until))
            check(bool(res.done.all()) and not res.live[10:16].any(),
                  f"10h {arch}: not every request done, or live during the outage")
            served[arch] = res.tokens_served
        print(f"  serving_smoke card == CPU (8 lanes, table and cells; one lane's tokens "
              f"and records); reduced engines card == CPU, tokens and records: {served}",
              flush=True)

    def protocol_serve_rwkv6(self):
        """The serving path on full-width rwkv6-1.6b, on counters of its
        own; phase 7's checks, then a decode of prompts of RWKV_DECODE_LEN tokens."""
        torch = self.torch
        from repro_torch.launch import protocol_inference as launch

        def drive():
            out = launch.main(["--arch", "rwkv6-1.6b", "--full", "--seq",
                               str(WKV_SHAPE["s"]), "--batch", str(WKV_SHAPE["b"])])
            g = torch.Generator(device=self.dev).manual_seed(6)
            prompts = torch.randint(0, out["model"].cfg.vocab_size,
                                    (DECODE_PROMPTS, RWKV_DECODE_LEN), generator=g,
                                    device=self.dev)
            gen, stats = out["server"].decode("customer", prompts, DECODE_NEW)
            return out, prompts, gen, stats

        out, prompts, gen, stats = self.counted("protocol_serve_rwkv6", drive)
        out["prompts"] = prompts
        cfg = out["model"].cfg
        check(cfg.use_pallas_kernels and cfg.family == "ssm" and cfg.d_model == 2048
              and cfg.num_layers == RWKV_LAYERS and out["n_params"] == RWKV_PARAMS,
              "not full-width rwkv6-1.6b")
        self.check_served(out, gen)
        self.profile_prefill(out, scan="wkv_scan")
        self.profile_decode_step(out)
        print(f"  protocol_serve_rwkv6: prefill of {WKV_SHAPE['b']} x {WKV_SHAPE['s']} tokens "
              f"{out['prefill_s']:.3f} s; decode {DECODE_PROMPTS} x {RWKV_DECODE_LEN} -> "
              f"{DECODE_NEW} new: {stats.tok_per_s:.1f} tok/s (prefill by stepping "
              f"{stats.prefill_s:.3f} s, decode {stats.decode_s:.3f} s); coalition "
              f"logits relative L2 {out['extract_rel']:.3f}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        del out["server"]
        return out

    def rwkv_decode_vs_prefill(self, out):
        """Decode against the kernel prefill on a float32 copy of the
        params: the prompts of phase 7c through the kernel prefill layer by
        layer (keeping each layer's s_final) and through ``decode_step``
        token by token, both free-running.  The reference's prefill rounds
        w to the model's dtype and decode does not; on the float32 copy the
        rounding does nothing, so the two must agree.  The served bf16
        params' gap is printed as the reference's quirk, not held."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.models import rwkv6 as R
        from repro_torch.models.common import rms_norm
        from repro_torch.models.model import build_model
        cfg = out["model"].cfg
        prompts = out["prompts"]
        cfg32 = replace(cfg, dtype="float32")
        params = {k: t.float() for k, t in out["params"].items()}
        model = build_model(cfg32)
        with torch.inference_mode():
            x = rms_norm(F.embedding(prompts, params["embed"]), params["ln_in"], cfg.norm_eps)
            states = []
            for lp in R._per_layer(params, cfg32):
                o, sf = R.time_mix_state(lp, cfg32, rms_norm(x, lp["ln_tm"], cfg.norm_eps))
                x = x + o
                x = x + R.channel_mix(lp, cfg32, rms_norm(x, lp["ln_cm"], cfg.norm_eps))
                states.append(sf)
            pre = self.last_logits(params, cfg32, x)
            logits, cache = model.decode_scan(params, prompts,
                                              model.init_cache(prompts.shape[0], 0, self.dev))
            gaps = [self.rel(cache["s"][i], states[i]) for i in range(cfg.num_layers)]
            gap = self.rel(logits[:, -1], pre)
            del params, cache, states, logits
            self.free()
            served = out["model"]
            bf_logits, _ = served.decode_scan(out["params"], prompts,
                                              served.init_cache(prompts.shape[0], 0, self.dev))
            bf_gap = self.rel(bf_logits[:, -1], served.prefill(out["params"],
                                                              {"tokens": prompts}))
        print(f"  float32 copy, {prompts.shape[0]} x {prompts.shape[1]} tokens: decode's "
              f"recurrent states vs the kernel's s_final within {max(gaps):.3e} relative L2 "
              f"(worst of {len(gaps)} layers; per layer {[float(f'{g:.2e}') for g in gaps]}), "
              f"last logits {gap:.3e}", flush=True)
        print(f"  served bf16 params: decode vs prefill last logits {bf_gap:.3e} relative L2 "
              f"(the reference's quirk: prefill rounds w to bf16, decode keeps float32; not "
              f"held)", flush=True)
        check(max(gaps) <= 1e-4 and gap <= 1e-3,
              f"decode and the kernel prefill differ on the float32 copy (states "
              f"{max(gaps):.3e}, bound 1e-4; logits {gap:.3e}, bound 1e-3)")

    def wkv_route_gap(self, out):
        """The served rwkv6 prefill's kernel route against the
        ``wkv_chunked`` route (``use_pallas_kernels`` off).  Teacher-forced:
        at each of the 24 layers both routes take the kernel route's input,
        and the layer's update and the last layer's logits must agree within
        1e-2 relative L2.  Free-running, the kernel route's logit gap to
        ``wkv_chunked`` is held to at most twice the gap between two routes
        without the kernel (``wkv_plain`` in its place)."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.core.serving import device_clock
        from repro_torch.kernels.rwkv6_wkv import ops
        from repro_torch.models import rwkv6 as R
        from repro_torch.models.common import rms_norm
        from repro_torch.models.model import build_model

        cfg_k = out["model"].cfg
        cfg_c = replace(cfg_k, use_pallas_kernels=False)
        params, tokens = out["params"], out["batch"]["tokens"]
        kernel_entry = R.wkv

        def plain_layer(lp, h):                   # wkv_plain for the kernel
            R.wkv = ops.wkv_plain
            try:
                return R.layer_apply(lp, cfg_k, h)
            finally:
                R.wkv = kernel_entry

        with torch.inference_mode():
            t0 = device_clock(self.dev)
            free = build_model(cfg_c).prefill(params, out["batch"])
            dt = device_clock(self.dev) - t0
            x = y = z = rms_norm(F.embedding(tokens, params["embed"]), params["ln_in"],
                                 cfg_k.norm_eps)
            gaps, free_gaps, witness_gaps = [], [], []
            for lp in R._per_layer(params, cfg_k):
                a = R.layer_apply(lp, cfg_k, x)
                b = R.layer_apply(lp, cfg_c, x)
                y = R.layer_apply(lp, cfg_c, y)         # the wkv_chunked route, free
                z = plain_layer(lp, z)                  # the plain route, free
                gaps.append(self.rel(a.float() - x.float(), b.float() - x.float()))
                free_gaps.append(self.rel(a, y))
                witness_gaps.append(self.rel(z, y))
                x = a
            la, lb = (self.last_logits(params, cfg_k, h) for h in (a, b))
            free_kernel = self.rel(out["ref"], free)
            free_witness = self.rel(self.last_logits(params, cfg_k, z), free)
        gap = self.rel(la, lb)
        print(f"  kernel route vs wkv_chunked route, teacher-forced: layer updates within "
              f"{max(gaps):.3e} relative L2 (worst of {len(gaps)} layers), logits "
              f"{gap:.3e}; the kernel route's logits equal the served ones: "
              f"{bool(torch.equal(la, out['ref']))}", flush=True)
        print(f"  free-running: kernel vs wkv_chunked logits {free_kernel:.3e}, hidden states "
              f"after each layer {[float(f'{g:.2e}') for g in free_gaps]}", flush=True)
        print(f"  free-running, no kernel on either side: wkv_plain vs wkv_chunked logits "
              f"{free_witness:.3e}, hidden states after each layer "
              f"{[float(f'{g:.2e}') for g in witness_gaps]}; wkv_chunked prefill {dt:.3f} s "
              f"vs kernel route {out['prefill_s']:.3f} s", flush=True)
        check(max(gaps) <= 1e-2 and gap <= 1e-2,
              f"kernel and wkv_chunked routes differ beyond 1e-2 (layers {max(gaps):.3e}, "
              f"logits {gap:.3e})")
        check(free_kernel <= max(1e-2, 2 * free_witness),
              f"free-running, the kernel route parts from wkv_chunked ({free_kernel:.3e}) "
              f"more than twice as far as two routes without the kernel ({free_witness:.3e})")

    def protocol_serve_zamba2(self):
        """The serving path on full-width zamba2-1.2b, on counters of its
        own; phase 7's checks and the peak memory, then a decode of prompts
        of ZAMBA_DECODE_LEN tokens."""
        torch = self.torch
        from repro_torch.launch import protocol_inference as launch

        def drive():
            out = launch.main(["--arch", "zamba2-1.2b", "--full", "--seq",
                               str(SSD_SHAPE["s"]), "--batch", str(SSD_SHAPE["b"])])
            peak = torch.cuda.max_memory_allocated()
            g = torch.Generator(device=self.dev).manual_seed(7)
            prompts = torch.randint(0, out["model"].cfg.vocab_size,
                                    (DECODE_PROMPTS, ZAMBA_DECODE_LEN), generator=g,
                                    device=self.dev)
            gen, stats = out["server"].decode("customer", prompts, DECODE_NEW)
            return out, prompts, gen, stats, peak

        out, prompts, gen, stats, peak = self.counted("protocol_serve_zamba2", drive)
        out["prompts"] = prompts
        cfg = out["model"].cfg
        check(cfg.use_pallas_kernels and cfg.family == "hybrid" and cfg.d_model == 2048
              and cfg.num_layers == ZAMBA_LAYERS and cfg.sliding_window is None
              and out["n_params"] == ZAMBA_PARAMS, "not full-width zamba2-1.2b")
        self.check_served(out, gen)
        # one (32,768 x 32,768) float32 score matrix of 32 heads is 128 GiB
        scores = SSD_SHAPE["s"] ** 2 * cfg.num_heads * 4
        check(peak < 40 * 2**30, f"the served prefill's peak {peak / 2**30:.2f} GiB")
        self.profile_prefill(out, scan="ssd_scan")
        self.profile_decode_step(out)
        print(f"  protocol_serve_zamba2: prefill of {SSD_SHAPE['b']} x {SSD_SHAPE['s']} tokens "
              f"{out['prefill_s']:.3f} s; decode {DECODE_PROMPTS} x {ZAMBA_DECODE_LEN} -> "
              f"{DECODE_NEW} new: {stats.tok_per_s:.1f} tok/s (prefill by stepping "
              f"{stats.prefill_s:.3f} s, decode {stats.decode_s:.3f} s); coalition "
              f"logits relative L2 {out['extract_rel']:.3f}; max_memory_allocated "
              f"{peak / 2**30:.2f} GiB through the served prefills (one full score matrix "
              f"would be {scores / 2**30:.0f} GiB), "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with the decode",
              flush=True)
        del out["server"]
        return out

    def profile_prefill(self, out, scan):
        """One served prefill (``Model.prefill`` of the phase's batch) under
        torch.profiler: device time, its share of the host time, and the
        kernels that take most of it.  The mean device ms a launch of each
        of the ``scan`` kernel's three CUDA kernels (chunk pass, state
        pass, output pass) is kept for its phase 9 row."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        model, params, batch = out["model"], out["params"], out["batch"]
        with torch.inference_mode():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.prefill(params, batch)
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3

        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(self_dev(e) for e in events)
        print(f"  one served prefill (profiled): {sum(e.count for e in events)} device ops, "
              f"{dev_ms:.1f} ms of device time in {host_ms:.1f} ms", flush=True)
        for e in sorted(events, key=self_dev, reverse=True)[:10]:
            print(f"    {self_dev(e):9.2f} ms  x{e.count:<6d} {e.key[:90]}", flush=True)
        split = {}
        for e in events:
            if any(part in e.key for part in ("_chunk_state<", "state_pass<", "_chunk_out<")):
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                split[name.removeprefix("void ")] = self_dev(e) / e.count
        self.scan_split[scan] = split or None
        print(f"    {scan} by launch (mean ms): "
              + (", ".join(f"{k} {v:.3f}" for k, v in split.items()) if split
                 else "not measured (no device time profiled)"), flush=True)

    def zamba_decode_vs_prefill(self, out):
        """Decode against the kernel prefill on a float32 copy of the params,
        teacher-forced on phase 7e's prompts: each layer takes the kernel
        prefill's input to it, through the prefill (the SSD kernel's
        h_final, the shared block's k, v) and stepped token by token
        through ``mamba_block_decode`` / ``layer_decode`` into a cache.
        Held: each mamba layer's state, each application's K/V cache, each
        layer's update and the last logits.  Then ``decode_scan``
        free-running from a zero cache: its gaps are printed."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.models import hybrid as Hy
        from repro_torch.models import mamba2 as M
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm
        from repro_torch.models.model import build_model
        cfg = replace(out["model"].cfg, dtype="float32")
        prompts = out["prompts"]
        b, s = prompts.shape
        params = {k: t.float() for k, t in out["params"].items()}
        model = build_model(cfg)
        groups, rem = Hy.mamba_layers(params, cfg)
        sp = Hy.shared_block(params)
        m = cfg.mamba_per_group
        positions = torch.arange(s, device=self.dev).expand(b, s)
        h_finals, state_gaps, kv_gaps, upd_gaps = [], [], [], []

        def mamba(lp, x, h, conv):
            xin = rms_norm(x, lp["ln"], cfg.norm_eps)
            o, hf = M.mamba_block_state(lp, cfg, xin)                  # the kernel prefill
            stepped = torch.cat([M.mamba_block_decode(lp, cfg, xin[:, t:t + 1], h, conv)
                                 for t in range(s)], dim=1)
            h_finals.append(hf)
            state_gaps.append(self.rel(h, hf))
            upd_gaps.append(self.rel(stepped, o))
            return x + o, x + stepped

        def shared(x, kc, vc):
            y = T._layer_apply(sp, cfg, x, positions)
            _, k, v = T._qkv(sp, cfg, rms_norm(x, sp["ln_attn"], cfg.norm_eps), positions)
            stepped = torch.cat([T.layer_decode(sp, cfg, x[:, t:t + 1], kc, vc, t)
                                 for t in range(s)], dim=1)
            kv_gaps.append(max(self.rel(kc, k), self.rel(vc, v)))
            upd_gaps.append(self.rel(stepped - x, y - x))
            return y, stepped

        with torch.inference_mode():
            cache = model.init_cache(b, s, self.dev)
            x = F.embedding(prompts, params["embed"])
            for gi in range(len(groups) // m):
                for li in range(m):
                    x, last = mamba(groups[gi * m + li], x, cache["mamba_g"]["h"][gi, li],
                                    cache["mamba_g"]["conv"][gi, li])
                x, last = shared(x, cache["attn_k"][gi], cache["attn_v"][gi])
            for ri, lp in enumerate(rem):
                x, last = mamba(lp, x, cache["mamba_rem"]["h"][ri], cache["mamba_rem"]["conv"][ri])
            pre = self.last_logits(params, cfg, x)
            gap = self.rel(self.last_logits(params, cfg, last), pre)
            del cache, x, last
            logits, free = model.decode_scan(params, prompts, model.init_cache(b, s, self.dev))
            free_h = list(free["mamba_g"]["h"].flatten(0, 1))
            if "mamba_rem" in free:
                free_h += list(free["mamba_rem"]["h"])
            free_states = [self.rel(hs, hf) for hs, hf in zip(free_h, h_finals)]
            free_gap = self.rel(logits[:, -1], pre)
            del params, free, logits, h_finals
            self.free()
        print(f"  float32 copy, {b} x {s} tokens, teacher-forced: SSD states vs the kernel's "
              f"h_final within {max(state_gaps):.3e} relative L2 (worst of {len(state_gaps)} "
              f"layers), K/V caches {max(kv_gaps):.3e} (worst of {len(kv_gaps)}), layer "
              f"updates {max(upd_gaps):.3e}, last logits {gap:.3e}", flush=True)
        print(f"  free-running decode_scan: SSD states vs the kernel's h_final per layer "
              f"{[float(f'{g:.2e}') for g in free_states]}, last logits {free_gap:.3e} "
              f"(printed, not held)", flush=True)
        check(max(state_gaps) <= 1e-4 and max(kv_gaps) <= 1e-5 and max(upd_gaps) <= 1e-3
              and gap <= 1e-3,
              f"decode and the kernel prefill differ on the float32 copy (states "
              f"{max(state_gaps):.3e}, bound 1e-4; K/V {max(kv_gaps):.3e}, bound 1e-5; "
              f"updates {max(upd_gaps):.3e} and logits {gap:.3e}, bound 1e-3)")

    def ssd_route_gap(self, out):
        """The served zamba2 prefill's SSD kernel route against the
        ``ssd_chunked`` route (``use_pallas_kernels`` off).  Teacher-forced:
        at each of the 38 mamba layers both routes take the kernel route's
        input, and the layer's update and the last layer's logits must
        agree within 1e-2 relative L2 (the shared block is the same on both
        routes).  Free-running, the kernel route's logit gap to
        ``ssd_chunked`` is held to at most twice the gap between two routes
        without the kernel (``ssd_plain`` in its place), or 1e-2; with the
        flag off the shared block takes the blockwise attention, so the
        witness route (``ssd_plain``) takes it too."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.core.serving import device_clock
        from repro_torch.kernels.mamba2_scan import ops
        from repro_torch.models import hybrid as Hy
        from repro_torch.models import mamba2 as M
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm
        from repro_torch.models.model import build_model

        cfg_k = out["model"].cfg
        cfg_c = replace(cfg_k, use_pallas_kernels=False)
        params, tokens = out["params"], out["batch"]["tokens"]
        groups, rem = Hy.mamba_layers(params, cfg_k)
        sp = Hy.shared_block(params)
        m = cfg_k.mamba_per_group
        order = []
        for gi in range(len(groups) // m):
            order += groups[gi * m:(gi + 1) * m] + [None]        # None: the shared block
        order += rem
        kernel_entry = M.ssd

        def plain_layer(lp, h):                   # ssd_plain for the kernel
            M.ssd = ops.ssd_plain
            try:
                return Hy._mamba_layer(lp, cfg_k, h)
            finally:
                M.ssd = kernel_entry

        with torch.inference_mode():
            t0 = device_clock(self.dev)
            free = build_model(cfg_c).prefill(params, out["batch"])
            dt = device_clock(self.dev) - t0
            x = y = z = F.embedding(tokens, params["embed"])
            positions = torch.arange(tokens.shape[1], device=self.dev).expand(tokens.shape)
            gaps, free_gaps, witness_gaps = [], [], []
            for lp in order:
                if lp is None:
                    a = b = T._layer_apply(sp, cfg_k, x, positions)
                    y = T._layer_apply(sp, cfg_c, y, positions)
                    z = T._layer_apply(sp, cfg_c, z, positions)
                else:
                    # the block's update, as _mamba_layer adds it to x
                    h = rms_norm(x, lp["ln"], cfg_k.norm_eps)
                    ua, ub = (M.mamba_block_apply(lp, c, h) for c in (cfg_k, cfg_c))
                    a, b = x + ua, x + ub
                    y = Hy._mamba_layer(lp, cfg_c, y)   # the ssd_chunked route, free
                    z = plain_layer(lp, z)              # the plain route, free
                    gaps.append(self.rel(ua, ub))
                free_gaps.append(self.rel(a, y))
                witness_gaps.append(self.rel(z, y))
                x = a
            la, lb = (self.last_logits(params, cfg_k, h) for h in (a, b))
            free_kernel = self.rel(out["ref"], free)
            free_witness = self.rel(self.last_logits(params, cfg_k, z), free)
        gap = self.rel(la, lb)
        print(f"  kernel route vs ssd_chunked route, teacher-forced: layer updates within "
              f"{max(gaps):.3e} relative L2 (worst of {len(gaps)} mamba layers), logits "
              f"{gap:.3e}; the kernel route's logits equal the served ones: "
              f"{bool(torch.equal(la, out['ref']))}", flush=True)
        print(f"  free-running: kernel vs ssd_chunked logits {free_kernel:.3e}, hidden states "
              f"after each layer {[float(f'{g:.2e}') for g in free_gaps]}", flush=True)
        print(f"  free-running, no kernel on either side: ssd_plain vs ssd_chunked logits "
              f"{free_witness:.3e}, hidden states after each layer "
              f"{[float(f'{g:.2e}') for g in witness_gaps]}; ssd_chunked prefill {dt:.3f} s "
              f"vs kernel route {out['prefill_s']:.3f} s", flush=True)
        check(max(gaps) <= 1e-2 and gap <= 1e-2,
              f"kernel and ssd_chunked routes differ beyond 1e-2 (layers {max(gaps):.3e}, "
              f"logits {gap:.3e})")
        check(free_kernel <= max(1e-2, 2 * free_witness),
              f"free-running, the kernel route parts from ssd_chunked ({free_kernel:.3e}) "
              f"more than twice as far as two routes without the kernel ({free_witness:.3e})")

    def causal_route_gap(self, out):
        """The served zamba2 prefill's shared-block attention on the kernel
        route (``swa_attention`` at window = S) against the blockwise route
        (``use_pallas_kernels`` off: the reference's float32 online softmax
        in blocks of 1,024).  Teacher-forced: the mamba layers run the
        served (kernel) route, and at each of the shared block's 6
        applications both routes take the kernel route's input; each
        application's update and the last logits (the remainder layers run
        on from each route's last application) must agree within 4e-3
        relative L2 (three times the reading of the kernel as it stands)."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.core.serving import device_clock
        from repro_torch.models import hybrid as Hy
        from repro_torch.models import transformer as T

        cfg_k = out["model"].cfg
        cfg_b = replace(cfg_k, use_pallas_kernels=False)
        params, tokens = out["params"], out["batch"]["tokens"]
        groups, rem = Hy.mamba_layers(params, cfg_k)
        sp = Hy.shared_block(params)
        m = cfg_k.mamba_per_group
        gaps, t_kernel, t_block = [], 0.0, 0.0
        with torch.inference_mode():
            x = F.embedding(tokens, params["embed"])
            positions = torch.arange(tokens.shape[1], device=self.dev).expand(tokens.shape)
            for gi in range(len(groups) // m):
                for lp in groups[gi * m:(gi + 1) * m]:
                    x = Hy._mamba_layer(lp, cfg_k, x)
                t0 = device_clock(self.dev)
                a = T._layer_apply(sp, cfg_k, x, positions)
                t1 = device_clock(self.dev)
                b = T._layer_apply(sp, cfg_b, x, positions)
                t_kernel += t1 - t0
                t_block += device_clock(self.dev) - t1
                gaps.append(self.rel(a.float() - x.float(), b.float() - x.float()))
                x = a
            for lp in rem:
                a, b = Hy._mamba_layer(lp, cfg_k, a), Hy._mamba_layer(lp, cfg_k, b)
            la, lb = (self.last_logits(params, cfg_k, h) for h in (a, b))
        gap = self.rel(la, lb)
        print(f"  shared block, kernel route vs blockwise route, teacher-forced: updates "
              f"within {max(gaps):.3e} relative L2 (worst of {len(gaps)} applications: "
              f"{[float(f'{g:.2e}') for g in gaps]}), last logits {gap:.3e}; the kernel "
              f"route's logits equal the served ones: {bool(torch.equal(la, out['ref']))}; "
              f"{len(gaps)} shared-block applications {t_kernel:.3f} s on the kernel route, "
              f"{t_block:.3f} s on the blockwise route", flush=True)
        check(len(gaps) == ZAMBA_SHARED, f"{len(gaps)} shared-block applications")
        check(max(gaps) <= 4e-3 and gap <= 4e-3,
              f"kernel and blockwise routes differ beyond 4e-3 (updates {max(gaps):.3e}, "
              f"logits {gap:.3e})")

    # -- mixtral: the MoE family at full width ------------------------------------
    @contextlib.contextmanager
    def routes(self):
        """Record every MoE routing made while open: per ``moe.route`` call,
        the chosen experts sorted (B, S, k) and each token's router margin
        p_k - p_(k+1) (B, S), the gap float order must cross to change its
        choice."""
        torch = self.torch
        from repro_torch.models import moe
        real, seen = moe.route, []

        def recording(x, router, top_k):
            out = real(x, router, top_k)
            probs = torch.softmax(torch.einsum("...d,de->...e", x.float(), router.float()), -1)
            top = torch.topk(probs, top_k + 1, dim=-1).values
            seen.append((out[1].sort(dim=-1).values, top[..., top_k - 1] - top[..., top_k]))
            return out

        moe.route = recording
        try:
            yield seen
        finally:
            moe.route = real

    def dropped(self, experts, cfg, seq):
        """The slots a prefill of ``seq`` tokens at ``cfg.moe_capacity_factor``
        drops, given its routing (B, S, k): per expert and row, the load past
        the capacity."""
        from repro_torch.models import moe
        cap = moe.capacity(seq, cfg.experts_per_token, cfg.num_experts, cfg.moe_capacity_factor)
        return int((moe.slot_ranks(experts, cfg.num_experts) >= cap).sum())

    def protocol_serve_mixtral(self):
        """Phase 7h: the serving path on full-width mixtral-8x7b with its
        depth cut to 3 layers, on counters of its own: 3 window-kernel
        launches a prefill; phase 7's checks; the params built equal to the
        cut config's ``param_count()``; then ``decode`` of 4 prompts of 392
        tokens, 16 new tokens.  Prints the prefill's time and the slots its
        MoE dropped at capacity factor 1.25, the decode's tok/s and ms a
        step, and the phase's peak memory, held below 72 GiB."""
        torch = self.torch
        from repro_torch.launch import protocol_inference as launch
        b, s = MIXTRAL_SHAPE["b"], MIXTRAL_SHAPE["s"]

        def drive():
            with self.routes() as seen:
                out = launch.main(["--arch", "mixtral-8x7b", "--full", "--layers",
                                   str(MIXTRAL_LAYERS), "--seq", str(s), "--batch", str(b)])
            g = torch.Generator(device=self.dev).manual_seed(5)
            prompts = torch.randint(0, out["model"].cfg.vocab_size,
                                    (DECODE_PROMPTS, MIXTRAL_DECODE_LEN), generator=g,
                                    device=self.dev)
            gen, stats = out["server"].decode("customer", prompts, MIXTRAL_DECODE_NEW)
            return out, seen, gen, stats

        out, seen, gen, stats = self.counted("protocol_serve_mixtral", drive)
        cfg = out["model"].cfg
        check(cfg.use_pallas_kernels and cfg.num_layers == MIXTRAL_LAYERS
              and (cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.experts_per_token) ==
              (4096, 14336, 8, 2) and cfg.sliding_window == MIXTRAL_SHAPE["window"]
              and (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (32, 8, 128),
              "not full-width mixtral-8x7b at 3 layers")
        check(out["n_params"] == cfg.param_count() == MIXTRAL_PARAMS,
              f"params built {out['n_params']:,}, param_count() {cfg.param_count():,}, "
              f"expected {MIXTRAL_PARAMS:,}")
        self.check_served(out, gen, MIXTRAL_DECODE_NEW)
        check(len(seen) == MIXTRAL_LAYERS * SERVE_PREFILLS, f"{len(seen)} MoE calls in the "
              f"launcher, expected {MIXTRAL_LAYERS * SERVE_PREFILLS}")
        drops = [self.dropped(e, cfg, s) for e, _ in seen[:MIXTRAL_LAYERS]]
        steps = MIXTRAL_DECODE_LEN + MIXTRAL_DECODE_NEW
        mem = torch.cuda.max_memory_allocated() / 2**30
        print(f"  protocol_serve_mixtral: {out['n_params']:,} params ({MIXTRAL_LAYERS} of 32 "
              f"layers); prefill of {b} x {s} tokens {out['prefill_s']:.3f} s, its MoE "
              f"dropping {drops} of {s * cfg.experts_per_token} slots a layer (capacity "
              f"factor {cfg.moe_capacity_factor}); decode {DECODE_PROMPTS} x "
              f"{MIXTRAL_DECODE_LEN} -> {MIXTRAL_DECODE_NEW} new: {stats.tok_per_s:.1f} tok/s, "
              f"{1e3 * (stats.prefill_s + stats.decode_s) / steps:.2f} ms a step (prefill by "
              f"stepping {stats.prefill_s:.3f} s, decode {stats.decode_s:.3f} s); coalition "
              f"logits relative L2 {out['extract_rel']:.3f}; max_memory_allocated "
              f"{mem:.2f} GiB; {self.card_name()}", flush=True)
        check(mem < MIXTRAL_MEM_GIB, f"peak memory {mem:.2f} GiB, not below {MIXTRAL_MEM_GIB}")
        del out["server"]
        return out

    def flip_rel(self, got, want, base, flip):
        """Relative L2 of the update ``got - base`` against ``want - base``
        over the (B, T) tokens that ``flip`` leaves out."""
        keep = ~flip
        return self.rel((got.float() - base.float())[keep], (want.float() - base.float())[keep])

    def hold_flips(self, what, flip, margin):
        """A routing that differs between two float orders: at most
        MOE_FLIP_FRAC of the tokens, each a near tie (router margin below
        MOE_FLIP_MARGIN)."""
        n = int(flip.sum())
        worst = float(margin[flip].max()) if n else 0.0
        check(n <= MOE_FLIP_FRAC * flip.numel() and worst < MOE_FLIP_MARGIN,
              f"{what}: {n} of {flip.numel()} tokens route otherwise, the widest router "
              f"margin among them {worst:.3e}")
        return n, worst

    def mixtral_decode_vs_prefill(self, out):
        """Phase 7i, on phase 7's 4 prompts of 4,160 tokens: the ring decode
        against the kernel prefill at capacity factor E / k (which drops no
        slot, as decode does not), teacher-forced over the last 64 positions,
        each writing over the 4,096-slot ring's oldest slot, as phase 7b
        does; and, teacher-forced on the same prompts, the kernel route
        against the ``_swa`` route, as phase 8 does.  MoE routing is
        discontinuous: a token whose router margin is a near tie may choose
        another expert under another float order, and its update then
        differs in full.  Such tokens are counted and held to be few and
        near ties; the rest are held to 1e-2 relative L2 layer by layer,
        and the last position's logits too where it routes alike.  Last,
        the served prefill (capacity factor 1.25) on the same prompts: the
        slots it drops, and its last logits' gap to the E / k prefill's."""
        torch = self.torch
        import torch.nn.functional as F
        from dataclasses import replace
        from repro_torch.models import transformer as T
        from repro_torch.models.attention import cache_length
        from repro_torch.models.common import rms_norm
        from repro_torch.models.model import build_model
        params, served = out["params"], out["model"].cfg
        cfg = replace(served, moe_capacity_factor=T.decode_capacity_factor(served))
        cfg_s = replace(cfg, use_pallas_kernels=False)
        g = torch.Generator(device=self.dev).manual_seed(5)
        prompts = torch.randint(0, cfg.vocab_size, (DECODE_PROMPTS, DECODE_LEN), generator=g,
                                device=self.dev)
        b, s = prompts.shape
        lc, start = cache_length(s, cfg.sliding_window), s - MIXTRAL_STEPS
        check(lc <= start, "the stepped positions do not write over the ring's oldest slots")
        check(cfg.moe_capacity_factor == cfg.num_experts / cfg.experts_per_token,
              "the prefill's capacity factor is not E / k")
        positions = torch.arange(s, device=self.dev).expand(b, s)
        first = start - lc                        # the ring holds positions first..start-1
        slots = torch.arange(first, start, device=self.dev) % lc
        dec, route, dec_flips, route_flips = [], [], [], []
        with torch.inference_mode():
            cache = build_model(cfg).init_cache(b, s, self.dev)
            x = F.embedding(prompts, params["embed"])
            for i, lp in enumerate(T._per_layer(params, cfg)):
                with self.routes() as seen:
                    y = T._layer_apply(lp, cfg, x, positions)        # kernel prefill, E / k
                    z = T._layer_apply(lp, cfg_s, x, positions)      # the _swa route
                (pe, pm), (ze, _) = seen
                h = rms_norm(x[:, first:start], lp["ln_attn"], cfg.norm_eps)
                _, k, v = T._qkv(lp, cfg, h, positions[:, first:start])
                kc, vc = cache["k"][i], cache["v"][i]
                kc[:, slots], vc[:, slots] = k, v
                with self.routes() as seen:
                    stepped = torch.cat([T.layer_decode(lp, cfg, x[:, t:t + 1], kc, vc, t)
                                         for t in range(start, s)], dim=1)
                de = torch.cat([e for e, _ in seen], dim=1)
                flip = (de != pe[:, start:]).any(-1)
                dec_flips.append(self.hold_flips(f"7i decode, layer {i}", flip, pm[:, start:]))
                dec.append(self.flip_rel(stepped, y[:, start:], x[:, start:], flip))
                rflip = (ze != pe).any(-1)
                route_flips.append(self.hold_flips(f"7i _swa route, layer {i}", rflip, pm))
                route.append(self.flip_rel(z, y, x, rflip))
                x = y
            last_alike = not bool(flip[:, -1].any())
            ek_logits = self.last_logits(params, cfg, x)
            gap = self.rel(self.last_logits(params, cfg, stepped), ek_logits)
            route_gap = self.rel(self.last_logits(params, cfg, z), ek_logits)
            with self.routes() as seen:
                narrow = build_model(served).prefill(params, {"tokens": prompts})
            drops = [self.dropped(e, served, s) for e, _ in seen]
        print(f"  decode vs kernel prefill (capacity factor {cfg.moe_capacity_factor}), "
              f"teacher-forced over positions {start}-{s - 1} (ring of {lc}): layer updates "
              f"within {max(dec):.3e} relative L2 over the tokens that route alike (per layer "
              f"{[float(f'{r:.2e}') for r in dec]}); tokens routed otherwise, and the widest "
              f"router margin among them, per layer {dec_flips} of {b * MIXTRAL_STEPS}; last "
              f"position's logits {gap:.3e} (it routes alike in the last layer: {last_alike})",
              flush=True)
        print(f"  kernel route vs _swa route, teacher-forced on {b} x {s}: layer updates within "
              f"{max(route):.3e} relative L2 over the tokens that route alike (per layer "
              f"{[float(f'{r:.2e}') for r in route]}); tokens routed otherwise per layer "
              f"{route_flips} of {b * s}; last logits {route_gap:.3e}", flush=True)
        print(f"  the served prefill (capacity factor {served.moe_capacity_factor}) on the same "
              f"prompts drops {drops} of {b * s * served.experts_per_token} slots a layer; its "
              f"last logits {self.rel(narrow, ek_logits):.3e} relative L2 from the E / k "
              f"prefill's", flush=True)
        check(max(dec) <= 1e-2 and (gap <= 1e-2 or not last_alike),
              f"decode and prefill differ beyond 1e-2 (layers {max(dec):.3e}, logits {gap:.3e})")
        check(max(route) <= 1e-2, f"kernel and _swa routes differ beyond 1e-2 "
                                  f"(layers {max(route):.3e})")

    def card_name(self):
        """The card's name and power limit, as nvidia-smi reads them."""
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}"

    def card_state(self):
        """The card's SM and memory clocks, power draw and temperature, as
        nvidia-smi reads them now."""
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                              "temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}"

    def time_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def timings(self):
        torch = self.torch
        from repro_torch.core import compression
        from repro_torch.kernels.centered_clip import ops as cc
        from repro_torch.kernels.masked_agg import ops as magg
        from repro_torch.kernels.qsgd import ops as qenc
        from repro_torch.kernels.qsgd_decode import ops as qdec
        n, d = N_NODES, D_FULL
        x = self.stack(n, d, seed=11)
        m = self.mask(n, "all")
        v = magg.masked_median(x, m)

        def nanquantile_chunks():
            step = (1 << 24) // n
            for c0 in range(0, d, step):
                torch.nanquantile(x[:, c0:c0 + step], 0.5, dim=0,
                                  interpolation="midpoint")

        f32 = 4
        # a yardstick for the CenteredClip rows: the stack read and written once
        clone_ms = self.time_ms(x.clone, 10)
        self.free()
        # the median also at K = 7 kept rows (the rounds mask nodes): it
        # reads only the kept rows, (K + 1) D * 4 bytes
        m7 = torch.arange(n, device=self.dev) < 7
        k7_bytes = (7 * d + d) * f32 + n * f32
        k7 = {"k7_ms": self.time_ms(lambda: magg.masked_median(x, m7), 10),
              "k7_bound_ms": k7_bytes / HBM_BYTES_PER_S * 1e3}
        print(f"    masked_median at K = 7: {k7['k7_ms']:.3f} ms (bound "
              f"{k7['k7_bound_ms']:.3f} ms, {k7_bytes} bytes)", flush=True)
        rows = [
            self.row("masked_median", lambda: magg.masked_median(x, m),
                     lambda: magg.masked_median_plain(x, m), nanquantile_chunks,
                     (n * d + d) * f32 + n * f32, 0, extra=k7),
            self.cc_row("masked_cc_iter",
                        lambda: magg.masked_cc_chain(x, v, m, iters=CC_ITERS, clip_tau=2.0),
                        lambda: magg.masked_cc_iter(x, v, m, clip_tau=2.0),
                        lambda: magg.masked_cc_iter_plain(x, v, m, 2.0), clone_ms),
            self.krum_row(x),
            # the sequential engine's chain over 10 survivors
            self.cc_row("cc_iter", lambda: cc.cc_chain(x, v, iters=CC_ITERS, clip_tau=2.0),
                        lambda: cc.cc_iter(x, v, clip_tau=2.0),
                        lambda: cc.cc_iter_plain(x, v, 2.0), clone_ms),
        ]
        del v
        # the showcase wire's encode of one node: x and u read, norms read,
        # int8 codes written; ~6 operations an element
        nb = -(-d // 512)
        xr = x[0]
        u = torch.rand((nb, 512), device=self.dev)
        norms = compression.bucket_norms(compression.pad_buckets(xr, 512)).reshape(-1)
        rows.append(self.row(
            "qsgd_encode",
            lambda: qenc.qsgd_encode_kernel(xr, u, norms, levels=127, bucket_size=512),
            lambda: qenc.qsgd_encode_plain(xr, u, norms, levels=127, bucket_size=512),
            None, d * f32 + nb * 512 * f32 + nb * f32 + nb * 512, 6 * nb * 512))
        del xr, u, norms
        nb = -(-d // BUCKET)
        codes = torch.randint(-LEVELS_WIRE, LEVELS_WIRE + 1, (n, nb * BUCKET),
                              dtype=torch.int8, device=self.dev)
        del x
        self.free()
        norms = torch.rand((n, nb), device=self.dev) * 30
        w = m.float()
        rows.append(self.row(
            "qsgd_decode_accumulate",
            lambda: qdec.decode_accumulate_kernel(codes, norms, w, levels=LEVELS_WIRE,
                                                  bucket_size=BUCKET),
            lambda: qdec.decode_accumulate_plain(codes, norms, w, levels=LEVELS_WIRE,
                                                 bucket_size=BUCKET),
            None, n * nb * BUCKET + n * nb * f32 + n * f32 + nb * BUCKET * f32, 0))
        del codes, norms, w
        self.free()
        rows += self.swa_rows()
        rows.append(self.wkv_row())
        rows.append(self.ssd_row())
        return rows

    def krum_row(self, x):
        """krum_d2 at the (10, D) stack.  Two PyTorch calls compute the same
        distances: ``torch.cdist(x, x) ** 2`` (at 10 rows cdist takes its
        pairwise-difference path) and ``torch.cdist(x, x, compute_mode=
        "use_mm_for_euclid_dist") ** 2`` (the Gram form through a matrix
        product, full float32: TF32 is off); the row's library column is the
        faster of the two, by name, both beside it."""
        torch = self.torch
        from repro_torch.kernels.masked_agg import ops as magg
        n, d = x.shape
        calls = {"torch.cdist(x, x) ** 2": lambda: torch.cdist(x, x) ** 2,
                 'torch.cdist(x, x, compute_mode="use_mm_for_euclid_dist") ** 2':
                     lambda: torch.cdist(x, x, compute_mode="use_mm_for_euclid_dist") ** 2}
        lib_ms = {name: self.time_ms(fn, 2) for name, fn in calls.items()}
        self.free()
        best = min(lib_ms, key=lib_ms.get)
        row = self.row("masked_krum_d2", lambda: magg.masked_krum_d2(x),
                       lambda: magg.masked_krum_d2_plain(x), None,
                       n * d * 4 + n * n * 4, n * (n + 1) * d,
                       extra={"library_call": best, "library_ms_by_call": lib_ms})
        row["library_ms"] = lib_ms[best]
        print(f"    masked_krum_d2: library {best} {lib_ms[best]:.3f} ms ("
              + ", ".join(f"{k} {v:.3f} ms" for k, v in lib_ms.items()) + ")", flush=True)
        return row

    def cc_row(self, name, chain, single, plain, clone_ms):
        """A CenteredClip row as the rounds run the kernel: the chain of
        CC_ITERS iterations over the (10, D) stack from the median, fixed
        tau 2.0.  ms, plain ms (one plain iteration) and the bound are an
        iteration's share of the chain's.  The bound counts each input read
        once and the output written once, (N + 2) D * 4 bytes for the whole
        chain; operations ~5 an element an iteration.  Beside it the
        dependency floor, the bytes of a design that forms each iteration's
        norms from x and the previous output, as this chain does:
        ((iters + 1) N D + (2 iters + 1) D) * 4 (x read iters + 1 times, v0
        read, each output written and, but the last, read again); the
        single-iteration call (the chain of 1) against its own bound, (N +
        2) D * 4 bytes; the chain's rate over the floor's bytes beside
        ``x.clone()``'s at the stack's shape (``clone_ms``, timed in the
        same call); and the mean ms of each of the chain's three launch
        kinds from phase 6b (masked) or 4b (dense)."""
        n, d, f32 = N_NODES, D_FULL, 4
        once_bytes = (n * d + 2 * d) * f32
        floor_bytes = ((CC_ITERS + 1) * n * d + (2 * CC_ITERS + 1) * d) * f32
        clone_rate = 2 * n * d * f32 / clone_ms / 1e9
        extra = {"iters": CC_ITERS, "dependency_floor_bytes": floor_bytes,
                 "dependency_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3 / CC_ITERS,
                 "launches_per_chain": 1 + 2 * CC_ITERS,
                 "single_ms": self.time_ms(single, 10),
                 "single_bound_ms": once_bytes / HBM_BYTES_PER_S * 1e3,
                 "clone_ms": clone_ms, "clone_TB_per_s": clone_rate,
                 "launch_ms": self.scan_split.get(name)}
        row = self.row(name, chain, plain, None, once_bytes / CC_ITERS, 5 * n * d,
                       per_call=CC_ITERS, extra=extra)
        row["chain_ms"] = row["ms"] * CC_ITERS
        row["chain_TB_per_s"] = floor_bytes / row["chain_ms"] / 1e9
        print(f"    {name}: chain of {CC_ITERS} {row['chain_ms']:.3f} ms (bound "
              f"{once_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, {once_bytes} bytes; dependency "
              f"floor {floor_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, {floor_bytes} bytes, moved "
              f"at {row['chain_TB_per_s']:.3f} TB/s against x.clone()'s {clone_rate:.3f}); one "
              f"iteration alone {extra['single_ms']:.3f} ms (bound "
              f"{extra['single_bound_ms']:.3f} ms)", flush=True)
        return row

    def wkv_row(self):
        """wkv_scan at the rwkv6 serving prefill's shape.  No single PyTorch
        call computes the WKV, so the library column is empty.  Bytes: r, k,
        v, w read and y written once (bf16), u read and s_final written
        (float32); operations: 4 K^2 flops a token and head (y = r^T S and
        the rank-1 state update, 2 K^2 each) at the bf16 tensor-core rate,
        as for swa_attention: the kernel's products run there (its hi/lo
        split and the chunk form make its own floor higher).  Beside them:
        the bytes the call holds beyond its outputs (its float32 scratch),
        and the mean time of each of its three launches in phase 7c's
        profiled prefill."""
        torch = self.torch
        from repro_torch.kernels.rwkv6_wkv import ops
        b, s, h, k = WKV_SHAPE.values()
        args = self.wkv_inputs(b, s, h, k, torch.bfloat16, seed=3)
        nbytes = 5 * b * s * h * k * 2 + h * k * 4 + b * h * k * k * 4
        return self.row("wkv_scan", lambda: ops.wkv_kernel(*args),
                        lambda: ops.wkv_plain(*args), None, nbytes, 4 * k * k * b * s * h,
                        BF16_FLOP_PER_S, scan=True)

    def ssd_row(self):
        """ssd_scan at the zamba2 serving prefill's shape (h0 none, as the
        prefill calls it).  No single PyTorch call computes the SSD, so the
        library column is empty.  Bytes: x read and y written (bf16), Δ
        read (float32), B and C read (bf16), a and d_skip read and h_final
        written (float32); operations: 4 N P flops a token and head (the
        state update and y = h C, 2 N P each) at the bf16 tensor-core rate,
        as for wkv_scan.  Scratch bytes as there; the launches' times from
        phase 7e's profiled prefill."""
        torch = self.torch
        from repro_torch.kernels.mamba2_scan import ops
        b, s, h, p, n = SSD_SHAPE.values()
        args = self.ssd_inputs(b, s, h, p, n, torch.bfloat16, seed=3)
        nbytes = (2 * b * s * h * p * 2 + b * s * h * 4 + 2 * b * s * n * 2 + 2 * h * 4
                  + b * h * p * n * 4)
        return self.row("ssd_scan", lambda: ops.ssd_kernel(*args),
                        lambda: ops.ssd_plain(*args), None, nbytes, 4 * n * p * b * s * h,
                        BF16_FLOP_PER_S, scan=True)

    def held_bytes(self, fn):
        """The bytes one call of ``fn`` holds on the card beyond what it
        returns: its peak allocation less the allocation once it returned
        (the caching allocator's counts)."""
        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        held = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
        del out
        return held

    def flex_band(self, qt, kt, vt, window):
        """One ``flex_attention`` call over the band only (a sliding-window
        block mask, compiled), or None and the reason where this torch
        cannot run it."""
        import os
        torch = self.torch
        # the compile's caches stay inside the checkout (build/ is ignored by git)
        for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
            os.environ.setdefault(var, str(ROOT / "build" / "torch_compile" / sub))
        try:
            from torch.nn.attention.flex_attention import create_block_mask, flex_attention

            def band(b, h, q_idx, kv_idx):
                return (q_idx >= kv_idx) & (q_idx - kv_idx < window)

            s = qt.shape[2]
            mask = create_block_mask(band, B=None, H=None, Q_LEN=s, KV_LEN=s, device=qt.device)
            flex = torch.compile(flex_attention)
            fn = lambda: flex(qt, kt, vt, block_mask=mask, enable_gqa=True)
            fn()
            torch.cuda.synchronize()
            return fn, None
        except Exception as e:                      # a yardstick only: say why, go on
            return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200] if str(e) else ''}"

    def swa_rows(self):
        """swa_attention at its three served shapes and at qwen3-moe's
        (whose full-width prefill is not driven; phase 3 has no case at its
        shape, so its kernel is held against plain here first).  danube's
        and mixtral's bands: the library call is one ``flex_attention`` with
        a sliding-window block mask (it computes only the band), or, where
        this torch cannot run it, one scaled_dot_product_attention with the
        band as a boolean mask (which scores all S^2 pairs).  The causal
        triangles (zamba2, qwen3): ``scaled_dot_product_attention(
        is_causal=True)``, the same function with p rounded to bf16.
        Operations: 4 hd flops a pair of this run's band (the kernel's
        hi/lo split of p does 6 hd)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.swa_attention import ops as swa
        rows = []
        for name, shape in (("swa_attention", SWA_SHAPE),
                            ("swa_attention@zamba2", CAUSAL_SHAPE),
                            ("swa_attention@mixtral", MIXTRAL_SHAPE),
                            ("swa_attention@qwen3", QWEN3_SHAPE)):
            b, s, hq, hkv, hd, window = shape.values()
            q, k, v = self.swa_inputs(b, s, hq, hkv, hd, torch.bfloat16, seed=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))          # (B, H, S, hd)
            kern = lambda: swa.swa_attention_kernel(q, k, v, window=window)
            print(f"  {name}: path {swa.kernel_path(s, hd, torch.bfloat16)}", flush=True)
            if name not in self.errors:        # no phase-3 case at this shape
                o = kern().float()
                r = swa.swa_attention_plain(q, k, v, window=window).float()
                err = self.record_err(name, o, r)
                self.row_errors[name] = self.row_rel(o, r)
                check(bool(((o - r).abs() <= 2e-2 + 2e-2 * r.abs()).all()),
                      f"{name}: beyond 2e-2 of its plain version ({err:.3e})")
                check(self.row_errors[name] <= SWA_ROW_REL, f"{name}: beyond {SWA_ROW_REL:.0e} "
                      f"mean row relative L2 of plain ({self.row_errors[name]:.3e})")
                print(f"  {name}: max abs err {err:.3e}, row rel L2 "
                      f"{self.row_errors[name]:.3e} against plain", flush=True)
                del o, r
            if window >= s:
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                             enable_gqa=True)
                lib_name = "sdpa is_causal"
            else:
                lib, why = self.flex_band(qt, kt, vt, window)
                lib_name = "flex_attention (band block mask)"
                if lib is None:
                    print(f"  flex_attention cannot run here ({why}); the library column is "
                          f"sdpa with the band as a boolean mask", flush=True)
                    i = torch.arange(s, device=self.dev)
                    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
                    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                                 enable_gqa=True)
                    lib_name = "sdpa boolean band mask"
            diff = (lib().transpose(1, 2).float() - kern().float()).abs().max()
            print(f"  {name}: library call {lib_name}, max abs diff to the kernel "
                  f"{float(diff):.3e}", flush=True)
            pairs = sum(min(j + 1, window) for j in range(s))        # this run's band
            nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)  # q, o, k, v in bf16
            rows.append(self.row(name, kern,
                                 lambda: swa.swa_attention_plain(q, k, v, window=window), lib,
                                 nbytes, 4 * hd * pairs * b * hq, BF16_FLOP_PER_S))
            del q, k, v, qt, kt, vt, kern, lib
            self.free()
        return rows

    def row(self, name, kern, plain, lib, nbytes, flops, flop_rate=FP32_FLOP_PER_S,
            scan=False, per_call=1, extra=None):
        """A kernel's row; ``kern`` does ``per_call`` units of the work that
        ``nbytes``, ``flops`` and ``plain`` do once, and ``ms`` is a unit's."""
        ms = self.time_ms(kern, 10) / per_call
        card = self.card_state()
        extra = dict(extra or {})
        if scan:       # the chunk-parallel scans: scratch, and their three launches in 7c/7e
            extra.update({"scratch_bytes": self.held_bytes(kern),
                          "launch_ms": self.scan_split.get(name)})
        plain_ms = self.time_ms(plain, 2)
        lib_ms = self.time_ms(lib, 2) if lib is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / flop_rate * 1e3
        src, replaces, path, *counter = KERNELS[name]
        counter = counter[0] if counter else name
        # launches: on the kernel's own path; by path: every driven path
        by_path = {p: c[counter] for p, c in self.launches.items() if c[counter]}
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": self.launches[path][counter] if path else 0,
               "launches_by_path": by_path,
               "max_abs_err": self.errors[name],
               **({"row_rel_l2": self.row_errors[name]} if name in self.row_errors else {}),
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": lib_ms, **extra}
        print(f"  {name}: {ms:.3f} ms (bound {row['bound_ms']:.3f} ms by "
              f"{row['bound_by']}, {row['bound_ms'] / ms:.1%} of it), plain "
              f"{plain_ms:.3f} ms, library {lib_ms}"
              + (f", scratch {extra['scratch_bytes']} bytes held" if scan else "")
              + (", by launch " + (", ".join(f"{k} {v:.3f} ms"
                                             for k, v in extra["launch_ms"].items())
                                   if extra["launch_ms"]
                                   else "not measured (no device time profiled)")
                 if "launch_ms" in extra else "") + f"; card after the kernel's timing: {card}",
              flush=True)
        self.free()
        return row


if __name__ == "__main__":
    sys.exit(main())
