#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases card,build,kernels
    python3 chip_smoke.py --phases card,build,cluster
    python3 chip_smoke.py --phases card,build,cluster,runtime
    python3 chip_smoke.py --phases card,build,launcher
    python3 chip_smoke.py --phases card,build,serve
    python3 chip_smoke.py --phases card,build,archs
    python3 chip_smoke.py --phases card,build,dense
    python3 chip_smoke.py --phases card,build,qwen
    python3 chip_smoke.py --phases card,build,whisper
    python3 chip_smoke.py --phases card,build,train
    python3 chip_smoke.py --phases card,build,sim
    python3 chip_smoke.py --profile       # + the slice's device time by kernel
    python3 chip_smoke.py --phases card,build,kernels --topk-sweep
                                          # + topk.cu rebuilt with other knobs
    python3 chip_smoke.py --phases card,build,kernels --ivf-sweep
                                          # + the same for ivf_topk.cu

Phases, in order:
  card     nvidia-smi name and power limit, capability (9, 0), TF32 off
  build    compile the CUDA kernels from src/repro_torch/kernels/csrc;
           print registers and spills (ptxas -v) and the HMMA
           (tensor-core) instruction count of each bf16 flash kernel
  slice    one RAG run at olmo-1b's full width (bf16, seeded random
           weights): FlatIndex top-k, paged chunked prefill with prefix
           forks, paged decode.  A first pass records, for each kernel,
           the inputs of its costliest call; the measured pass starts
           with every launch count at 0 and checks answers, prefix hits,
           finite logits and that every kernel was launched on this path
  cluster  the README quickstart's first two nodes at published width
           (bf16): olmo-1b (node 0, seed 0) and xlstm-350m (node 1, seed
           1, mLSTM/sLSTM with per-row recurrent state), each over its
           own domain-partitioned shard behind an IVFIndex on the card,
           with a semantic query cache and one sketch-routed
           FederatedRetriever, serving two slots each through the paged
           continuous queue.  A warm pass records the IVF kernel's
           costliest inputs; the measured pass, on fresh nodes with
           every launch count at 0, checks answers (equal to the warm
           pass), cache and prefix hits on each node (on node 1, forks
           from a recurrent-state snapshot), remote contexts, finite
           logits and the path's kernel launches, node by node (node 1
           launches the IVF probe and no attention kernel).  A last
           pass of node 1's slots, synchronised around every prefill
           chunk, decode step and recurrent cell, splits its time
           between mLSTM and sLSTM layers
  runtime  the scheduler's path (ClusterRuntime and replay_trace, as
           cluster_serve drives them) over fresh per-slot nodes of the
           same cluster (the cluster phase's weights): the PPO
           identifier on the card, ClusterRuntime with metrics and SLO
           feedback, profiled capacities, then replay_trace of 3 uniform
           slots of 12 queries at SLO 1.5 s (every launch count at 0
           just before, read just after: the IVF probe on both nodes,
           attention on node 0 only); checks a PPO update ran and every
           query has a result; prints capacities, per-slot load,
           quality, drops, latency and firing nodes, identify and
           ppo_update ms (CUDA events) and Algorithm 1's host ms.  Then
           the same runtime at the smoke config (f32) on the card and on
           the CPU, capacities pinned: assignments, answers and
           ppo_updates equal, the policies after the update within the
           CPU tests' tolerance
  launcher the port's launcher (src/repro_torch/launch/cluster_serve.py).
           (a) build_cluster over the cluster phase's weights with
           standing paged queues (one session per node for the whole
           run), SJF admission, federated IVF retrieval and semantic
           caches; span tracing on (obs.enable, which also feeds the SLO
           monitors); ClusterRuntime with SLO feedback, profiled; a spike
           replay of 4 slots of base 12 at SLO 1.5 s (every launch count
           at 0 just before, read just after: the IVF probe on both
           nodes, attention on node 0 only); runtime.close() drains the
           standing sessions.  Checks nothing is unfinished after it,
           every query has a result, one paged frame per node, and that
           the exported trace (build/trace_launcher.jsonl) passes
           tools/trace_report.py --check; prints per-slot drop rate, p50
           and p95, TTFT per node, span counts and total ms by span name,
           the trace's size and peak device memory, and whether a request
           straddled a slot.  (b) The README's cluster_serve command and
           CI's saturation smoke through the port's main on the card
           (traces under build/, each through trace_report --check, the
           metrics self-probe printing OK, a non-zero exit failing the
           phase), each with its own launch counts (flat top-k and
           attention launched)
  serve    the non-paged serving engine's entry points.  (a) The port's
           serve.py at olmo-1b's published width (bf16, seeded weights):
           --batch 4 --requests 8 --prompt-len 256 --new-tokens 16
           --max-len 512 --reference, waves of buckets 256 and 128; (b)
           the same at xlstm-350m's with --prompt-len 64 (exact-length
           waves); tokens/s of the queue and of one wave through generate
           and generate_reference, waves and slot utilization.  (c)
           build_cluster over the cluster phase's weights without --paged
           (the continuous queue over the contiguous cache, the
           reference's default run) and with the wave queue, each
           profiled and replaying 3 uniform slots of 12 at SLO 1.5 s
           under ClusterRuntime: per slot load, drop rate, p50 and p95,
           per node TTFT, queries/s, drop rate and p95; then
           cluster_serve --smoke --nodes 2 --slots 3, with and without
           --queue wave, through the port's main.  Each run has its own
           launch counts (0 just before, read just after): flash
           attention and the top-k launched, paged decode not; xlstm-350m
           launches no attention.  (d) At the smoke configs (f32), card
           against CPU: the greedy tokens of generate,
           generate_reference, the wave queue and the non-paged
           continuous queue equal, on both archs.  (e) flash_attention.cu
           against its plain version at the three call shapes the runs
           gave it (the largest of each: a wave's padded prompt, a chunk
           over the row's whole buffer, a decode query over it), timed
           beside its plain version and SDPA; their rows go into the
           kernels line under the flash kernel's "shapes"
  archs    the quickstart's other two node archs, hymba-1.5b (Mamba heads
           beside rolling-window attention, window 1024, GQA 25/5, head
           dim 64) and qwen2-moe-a2.7b (60 routed experts, top 4, and a
           shared expert).  (a) serve.py at each arch's published width
           (bf16, seed 0), --prompt-len 256 and serve's other flags as
           above: waves, slot utilization, tokens/s of generate and
           generate_reference on one wave.  (b) A hymba-1.5b wave that
           wraps its 1024-slot rolling buffer (prompts of 1100 and 1050
           tokens, max_len 1536, 24 new tokens): generate ==
           generate_reference, the first tokens equal the full forward's
           argmax, most later ones the teacher-forced forward's.  (c)
           build_cluster(4) over the four archs at published width
           (olmo-1b and xlstm-350m the cluster phase's, hymba-1.5b seed 2,
           qwen2-moe-a2.7b seed 3; ~35 GB of bf16 weights),
           cluster_serve's defaults, under ClusterRuntime with SLO
           feedback, profiled, 3 uniform slots of 12 at SLO 1.5 s, once
           --paged (prefix cache) and once non-paged: per slot load, drop
           rate, p50 / p95; per node mean TTFT, decode tokens/s in decode
           segments, drop rate, p95 and launches (flash on the hymba node
           and no paged decode: its K/V is per row; paged decode on the
           qwen2-moe node when paged); then one synchronised slot of the
           hymba node: the Mamba share of prefill and decode.  (d) At the
           smoke configs (f32), card against CPU: greedy tokens of
           generate, generate_reference, the wave queue, the non-paged
           continuous queue and the paged queue with a forked prefix
           equal, both archs; cluster_serve --smoke --nodes 4 --paged
           --standing on the card, its trace through trace_report
           --check.  (e) flash_attention.cu at hymba's shapes (a chunk of
           16 over a wrapped 1024-slot buffer; (a)'s wave prefill
           [4,256,25,64]; (b)'s decode over the wrapped buffer) and at
           the qwen2-moe node's chunk, paged_attention.cu at its decode,
           each against the plain version, timed beside it and the
           library call (rows under each kernel's "shapes"); the MoE
           layer's ms at decode (gathered weights) and at chunks
           (per-expert products)
  dense    the dense decoders llama3-8b (GQA 32/8, rope theta 5e5),
           gemma2-9b (serve.py's default: "local" layers of window 4096
           beside global ones, softcaps 50 and 30, GeGLU, hd 256, GQA 16/8)
           and nemotron-4-15b (LayerNorm, squared ReLU, GQA 48/8), one at
           a time at published width (bf16, seed 0; ~18.5, 16 and 31 GB),
           each freed before the next.  (a) serve.py with no --arch
           (gemma2-9b), then --arch llama3-8b and nemotron-4-15b,
           --prompt-len 256 and serve's other flags as above: waves, slot
           utilization, tokens/s of generate and generate_reference and
           their tokens equal.  (b) A gemma2 wave of 4200 and 4150 tokens
           (bucket 4328), max_len 4352, 24 new tokens: the 4096-slot local
           buffers wrap in prefill and again in decode, the global layers'
           do not; generate == generate_reference, the first tokens equal
           the full forward's argmax and most later ones the
           teacher-forced forward's (the head applied only at the compared
           columns).  (c) The paged continuous queue with the prefix cache
           (batch 4, chunk 32, blocks of 16, max_len 768) over each arch:
           7 requests, a 300-token context forked into refills; each
           request's tokens against a solo generate_reference run on the
           card (equal, or first parting where both tokens lie within
           NEAR_TIE of the forward's top logit); its own launch counts
           (paged decode and flash).  (d)
           At the smoke configs (f32), card against CPU: greedy tokens of
           generate, generate_reference, the wave queue, the non-paged
           continuous queue, the paged queue with a forked prefix and the
           paged standing queue equal, all three archs.  (e) the paged
           decode kernel at (c)'s decodes (gemma2 q [4,16,256] with softcap
           50, llama3 [4,32,128], nemotron [4,48,128]) and the flash kernel
           at hd 256 (gemma2's paged chunk of 32, softcap 50; (b)'s local
           decode over the wrapped buffer), each against its plain
           version, timed beside it and SDPA (rows under each kernel's
           "shapes")
  qwen     qwen3-moe-30b-a3b (per-head RMS qk-norm, 128 experts top-8,
           GQA 32/4) and qwen2-vl-72b (M-RoPE sections 16/24/24, 256
           stub patch embeddings before the text, GQA 64/8), one model
           at a time, each freed before the next.  (a) serve.py --arch
           qwen3-moe-30b-a3b at published width (bf16, ~61 GB) with
           --prompt-len 256 and serve's other flags as above, and
           serve.py --arch qwen2-vl-72b --smoke; qwen3 at published width
           again through dense's paged queue (c) against solo runs, and
           its MoE layer timed at a decode of 2 and 4 rows and a chunk
           of 32 by each route.  (b) qwen2-vl-72b at the deepest whole
           number of its 80 layers that fits the card beside
           VL_RESERVE_BYTES (32 on an H100 80GB): a prefill of 2 rows
           of 256 patches + 40 tokens at t/h/w positions that differ
           over the patches, then decode steps (the prefill's logits within NEAR_TIE of the
           forward's, the h/w positions moving them by more, each greedy
           token the teacher-forced forward's or a near-tie), then the
           paged queue against solo runs.  Peak memory of each model.
           (c) Card against CPU at the smoke configs (f32), qwen3 also at
           128 experts top-8: every serving path's greedy tokens, and
           qwen2-vl's forward, prefill and decode over an 8-patch prefix
           at t/h/w positions within 1e-4.  (d) The paged decode kernel at
           G 8 exactly (qwen3 q [4,32,128] over 4 KV heads, qwen2-vl
           [4,64,128] over 8) and the flash kernel's Sq > 16 route at G 8,
           hd 128 (qwen3's paged chunk of 32, qwen2-vl's 296-query vision
           prefill), each against its plain version, timed beside it and
           SDPA (rows under each kernel's "shapes")
  whisper  whisper-base at published width (bf16, seed 0: 6 encoder and 6
           decoder layers, d 512, 8 heads of 64, 1500 encoder frames,
           learned decoder positions), served text-only on the stub
           frontend's zero frames as the reference serves it.  (a)
           serve.py --arch whisper-base with --prompt-len 256 and serve's
           other flags as above, peak memory.  (b) dense's paged queue
           with the prefix cache over requests of power-of-two lengths (a
           240-token context forked into four 16-token questions, plain
           prompts of 64, 128 and 32 tokens: a solo wave reads its learned
           positions at absolute positions, so only an unpadded solo run
           shares the queue's frame), each against a solo run on the card
           (equal, or parting at a near-tie); its own launch counts;
           then the logits behind such tokens: two 256-token rows
           through the forward, a wave prefill + 7 decode steps and paged
           chunks of 32 + 7 decode steps, within WHISPER_LOGIT_TOL of the
           teacher-forced forward's (random weights make each greedy
           stream repeat one token, so the tokens alone say little).  (c)
           The paged standing queue over the same requests in three
           rounds, one straddling a round, held to the solo runs the same
           way.  (d) Card against CPU at the smoke config (f32): every
           serving path's greedy tokens, then the encoder, the forward,
           prefill + decode and paged chunks + decode within 1e-4.  (e)
           The flash kernel at the encoder's [4,1500,8,64] (non-causal),
           a cross-attention chunk of 32 queries and the cross-attention
           decode of 4 rows over the 1500 frames' K/V, and the paged decode
           kernel at G 1, hd 64, all from (b)'s queue, each against its
           plain version, timed beside it and SDPA (rows under each
           kernel's "shapes").  (f) (b)'s queue again, synchronised
           around every chunk, encoder pass and decode step: the
           encoder's share of a paged chunk
  train    the training path (src/repro_torch/train, launch/train.py,
           launch/train_tiny.py, cluster_serve --ckpt).  (a)
           csrc/flash_attention_bwd.cu against autograd of the plain
           version on the card at olmo-1b's training shape (q = k
           [4,256,16,128] causal, bf16), at [2,128,16,256] over 8 KV
           heads with window 64 and softcap 50 (bf16), at a small f32
           shape with invalid kv slots and G 2, and at whisper-base's
           encoder ([4,1500,8,64], not causal, bf16); each timed beside
           the plain backward and SDPA's (no softcap form) with its
           bound.
           (b) launch/train.py --arch olmo-1b --steps 6 --batch 4 --seq
           256 --ckpt through its main at published width (bf16, remat
           on): every launch count at 0 just before and read just after,
           16 layers x (forward + its recompute) flash forwards and 16
           flash_attention_bwd a step, no plain attention run; finite
           losses, step ms, tokens/s, peak memory; the checkpoint loads
           back into equal params.  (c) The same model, one fixed batch,
           8 steps: the loss falls.  (d) Card against CPU at the smoke
           configs (f32): one train step of olmo-1b, gemma2-9b (window
           16) and qwen2-moe-a2.7b, loss, aux, every gradient leaf and
           the updated params.  (e) launch/train_tiny.py at its defaults
           on the card, then cluster_serve --smoke --nodes 2 --slots 2
           with --ckpt (node 0 serves the trained weights, node 1 draws
           its own) and without: each slot's mean quality side by side
  kernels  each kernel against its plain PyTorch version on the card, on
           the inputs recorded from the main paths (synthetic inputs of
           the same shapes when a path did not run) and on edge cases,
           with the tolerance stated; median L2-cold times of the
           kernel, its plain version and one library call that computes
           the same function (a yardstick the port never calls), beside
           the bound of the same work on an H100; two calls of each
           attention kernel on the main-path inputs are bitwise equal;
           paged decode also at forced split counts, with B 1 and B 32
           2048-token contexts, flash also on a 256-query chunk after
           1792 keys; exact top-k also on ties across tiles and splits,
           Nq 33 and 65, D 30 and 2048, Nd 1, an unaligned pointer and
           a 1M-doc shard (Nq 32 at k 5 and 32, Nq 1), with two calls
           bitwise equal and the device kernels of one main-path call
           counted under torch.profiler; the IVF probe also on its edge
           cases (a list probed twice, more pairs for a list than a
           group holds, -1 slots inside lists, duplicates across lists
           and splits, probe ids outside the lists, D 30, an unaligned
           pointer) and on a trained 1M-doc shard (Nq 32 at k 5 and 32,
           Nq 1; forced split counts; a gathering and a dense masked
           yardstick), with two calls bitwise equal and the scan and
           merge kernels of one main-path call counted; the exact top-k
           above k 32 and its route on (Nq, Nd, k) (csrc/topk_list.cu for
           small corpora and single queries at small k,
           csrc/topk_select.cu the rest): the route of each shape by launch
           counts; the list kernel forced at k 33, 64, 256, 1024, above Nd
           and the limit, ties across tiles and splits (at forced split
           counts, groups 4 and 8 and merge depths), D 30, Nq 1, an
           unaligned pointer, the 1M-doc shard at Nq 1 (its route) and
           Nq 32 (forced, groups 8 and 4, beside the route's kernel);
           csrc/topk_select.cu at k 6177 over 8192 docs, at the k-th
           score (integer data), D 30, an unaligned pointer and the 1M-doc
           shard (Nq 32 at k 6177, 16384 and 65536, Nq 1), the limit + 1's
           first 6176 bitwise equal to the list kernel's k 6176 and first
           32 to the narrow k 32; the grid of both kernels forced at k 64
           .. 6176, Nq 1 / 8 / 32 and Nd 240 / 8192 / 1M beside the routed
           call and topk(q @ d.T) (kernels_topk_grid, also written to
           build/topk_grid.json); the IVF probe's route from k 16
           (csrc/ivf_select.cu) at k 33, 64, 257 and above the candidates
           on the main-path inputs and at k 33 .. 5000 over 4500
           candidates a query, with IVF padding, -1 slots inside a list, a
           list probed twice, one doc in two lists (tied by probe rank)
           and probe ids outside the lists, and on the 1M-doc IVF shard
           (Nq 32 and 1, k 64 and 6177); k 64's first 32 bitwise equal to
           the narrow k 32; two calls bitwise equal; times at k 64 on the
           main-path inputs and the shard beside the dense masked call,
           the grid of the route at k 33 .. 6177 beside it and the select
           route forced at k 3 .. 32 beside csrc/ivf_topk.cu
           (kernels_ivf_grid); the device kernels of the select routes
           under torch.profiler
  parity   the same slice at the olmo-1b smoke config (f32), and the
           two-node cluster with two olmo-1b nodes and with olmo-1b +
           xlstm-350m, on the card and on the CPU from the same weights:
           answers (and the nodes' contexts and sources) agree; the
           xlstm-350m smoke model's forward, chunk and decode logits
           agree within 1e-4 and its recurrent state after a
           left-padded chunk within atol 1e-5, rtol 1e-4
  sim      examples/hierarchical_scheduling_sim.py through the port: (a)
           the paper's four-node testbed (make_paper_testbed, seed 0),
           each node profiled at 5, 15 and 30 s (SIM_LEVELS: three of the
           example's six levels) and timed, C(L) = k L + b
           printed; (b) the 20-slot diurnal trace (5,984 queries, SLO
           15 s) through the Coordinator with the PPO identifier (64 x 4,
           an update every 256 feedbacks) on the card: per slot the
           query count, quality and drop rate in [0, 1], loads summing
           to 1 and updates_done never falling (> 0 after slot 0) are
           checked, and quality, drops, loads and wall printed; the
           policy and its Adam state must be on the card; identify and
           ppo_update ms (CUDA events), the OCO schedule's host ms per
           node and the device's busy share of the loop (torch.profiler;
           the phase runs last, as its profiler session can leave a
           later one empty) printed; (c) the first 3 slots again from the same initial
           policy on fresh testbeds with (a)'s capacities, card against
           CPU: equal up to the first PPO update, then routed on the
           card's probabilities with the policies held as the runtime
           parity holds them; (d) the first 6 slots under the Random
           and LinUCB routers and the oracle (Table II's shape; the
           oracle's quality beats random's by more than 0.02), and node
           3 under the OCO schedule and the four fixed deployments at
           500 queries (Table III's shape)

The lines before the last are the card's nvidia-smi name and power limit
and the kernels' JSON record; the last line is {"ok": true, "device":
{...}}.  Any failure exits non-zero before those lines are printed.
Exits 2 when no CUDA device is available or when the port's sources are
not beside this script.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
ALL_PHASES = ("card", "build", "slice", "cluster", "runtime", "launcher",
              "serve", "archs", "dense", "qwen", "whisper", "train",
              "kernels", "parity", "sim")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2 ** 20
DEV = "cuda"      # where the slice and the kernel cases run
TOPK_SWEEP = False   # --topk-sweep: time topk.cu rebuilt with other knobs
IVF_SWEEP = False    # --ivf-sweep: the same for ivf_topk.cu
SHARD_DOCS = 1_000_000   # a realistic index shard: 1M docs x D=256, f32

KERNEL_META = {
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:90"),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:93"),
    # no Pallas backward: the gradient of the reference's jnp attention,
    # which its train step differentiates
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/models/layers.py:161"),
    "retrieval_topk": (
        "src/repro_torch/kernels/csrc/topk.cu",
        "src/repro/kernels/topk_retrieval.py:72"),
    "ivf_retrieval_topk": (
        "src/repro_torch/kernels/csrc/ivf_topk.cu",
        "src/repro/kernels/topk_retrieval.py:143"),
    "retrieval_topk_list": (
        "src/repro_torch/kernels/csrc/topk_list.cu",
        "src/repro/kernels/topk_retrieval.py:72"),
    "retrieval_topk_select": (
        "src/repro_torch/kernels/csrc/topk_select.cu",
        "src/repro/kernels/topk_retrieval.py:72"),
    "ivf_retrieval_topk_select": (
        "src/repro_torch/kernels/csrc/ivf_select.cu",
        "src/repro/kernels/topk_retrieval.py:143"),
}
TOPK_KERNEL = re.compile(r"\btopk_(scan|merge)_kernel\b")
IVF_KERNEL = re.compile(r"\bivf_(scan|merge)_kernel\b")
# the cluster phase's nodes: the first two of the README quickstart's
CLUSTER_ARCHS = ("olmo-1b", "xlstm-350m")
# the kernels each main path must launch
SLICE_KERNELS = ("paged_decode_attention", "flash_attention",
                 "retrieval_topk")
CLUSTER_KERNELS = ("ivf_retrieval_topk", "flash_attention",
                   "paged_decode_attention")
# the public wrappers of ops
WRAPPERS = ("paged_decode_attention", "flash_attention", "retrieval_topk",
            "ivf_retrieval_topk")


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_ms(fn, reps: int = 25, cold: bool = True) -> float:
    """Median device time of one call of ``fn`` with a cold L2 (warm when
    ``cold`` is False), by CUDA events.  Before each call a write of
    twice the L2 evicts it and a device sleep (about 0.5 ms, longer than
    a wrapper's enqueue on a loaded host) keeps the card busy while the
    host enqueues the call, so the events bracket the device work and not
    the host's launch (a plain version of many small operations still
    shows the host gaps between them)."""
    import torch
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b, mask=None) -> float:
    d = (a.float() - b.float()).abs()
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def tolerance(want) -> float:
    """f32: 2e-5 absolute (the same f32 math summed in another order;
    both attention kernels keep f32 arithmetic for f32 inputs).
    bf16: two bf16 ulps of the largest output, 2^-7 max(1, max|out|).
    The kernel and the plain version round the f32 result to bf16 at
    slightly different f32 values: one ulp apart at most.  The bf16
    flash kernel also rounds the softmax weights P to bf16 for its
    tensor-core P V product, a relative error of at most 2^-9 per weight,
    so at most 2^-9 max|v| on an output (weights sum to 1).  That worst
    case needs every rounding to push one way; the roundings of
    independent weights cancel like a random walk, which keeps the sum
    far inside the second ulp (the cases print their errors)."""
    import torch
    if want.dtype == torch.bfloat16:
        return 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    return 2e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------------------ work counts


def paged_work(q, k_pool, tables, first, last):
    """Bytes and flops one paged decode call needs on these inputs: the
    K/V of the slots that count read once, q, tables and positions read,
    the output written."""
    bs, KV, hd = k_pool.shape[1:]
    H = q.shape[1]
    elt = k_pool.element_size()
    tb, lo, hi = tables.cpu(), first.cpu(), last.cpu()
    slots = 0
    for b in range(q.shape[0]):
        for j in range(tb.shape[1]):
            if tb[b, j] < 0:
                continue
            a = max(int(lo[b]), j * bs)
            z = min(int(hi[b]), j * bs + bs - 1)
            slots += max(0, z - a + 1)
    nbytes = (2 * slots * KV * hd * elt + 2 * q.numel() * q.element_size()
              + 4 * (tables.numel() + 2 * q.shape[0]))
    return nbytes, 4 * H * hd * slots


def flash_work(q, k, q_pos, kv_pos, causal=True, window=None):
    """Bytes and flops of one position-masked flash call: the K/V rows
    that some query may see read once, q and positions read, the output
    written; 4*hd flops per head per valid (query, key) pair."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    valid = (kp >= 0) & (qp >= 0)
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (qp - kp < window)
    pairs = int(valid.sum())
    keys = int(valid.any(dim=1).sum())
    nbytes = (2 * keys * KV * hd * k.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (q_pos.numel() + kv_pos.numel()))
    return nbytes, 4 * H * hd * pairs


def topk_work(q, d, k):
    nq, dim = q.shape
    return 4 * (d.shape[0] * dim + nq * dim) + 8 * nq * k, \
        2 * nq * d.shape[0] * dim


def ivf_work(q, list_emb, list_ids, probe, k, per=None):
    """Bytes and flops one IVF probe needs on these inputs: the live rows
    (and the id rows) of the distinct probed lists read once, queries
    and probe ids read, the output written; 2*D flops per live row per
    (query, probe).  Also returns the bytes this kernel reads from its
    lists: each split's live span (first to last live slot; ``per`` rows
    a split, the plan's when None) once per group of ``IVF_GROUP`` pairs
    that name the list, plus each probed list's id row; and the bytes of
    one read per (query, probe) of the live rows, the design this
    kernel replaced."""
    from repro_torch.kernels import ops
    import torch
    Nq, D = q.shape
    n_lists, L = list_ids.shape
    if per is None:
        sms = (torch.cuda.get_device_properties(q.device)
               .multi_processor_count if q.is_cuda else 132)
        per = ops.ivf_retrieval_topk_plan(Nq, probe.shape[1], n_lists, L,
                                          sms)[2]
    ids = list_ids.cpu()
    live = (ids >= 0).sum(dim=1)
    pr = probe.long().cpu().reshape(-1)
    pr = pr[(pr >= 0) & (pr < n_lists)]
    pairs = torch.bincount(pr, minlength=n_lists)
    valid = pairs > 0
    rows = int((live * pairs).sum())
    nbytes = (int(live[valid].sum()) * D * 4 + int(valid.sum()) * L * 4
              + q.numel() * 4 + probe.numel() * 4 + 8 * Nq * k)
    span = _ivf_spans(ids, per).sum(dim=1)
    groups = -(-pairs // ops.IVF_GROUP)
    traffic = int((span * groups).sum()) * D * 4 + int(valid.sum()) * L * 4
    return nbytes, 2 * D * rows, traffic, rows * D * 4


def _ivf_spans(ids, per):
    """[n_lists, splits]: rows from the first to the last live slot of
    each split of ``per`` rows (0 where a split holds none)."""
    import torch
    n_lists, L = ids.shape
    n_splits = -(-L // per)
    pad = torch.full((n_lists, n_splits * per), -1, dtype=ids.dtype)
    pad[:, :L] = ids
    alive = (pad >= 0).view(n_lists, n_splits, per)
    first = alive.int().argmax(dim=2)
    last = per - 1 - alive.flip(2).int().argmax(dim=2)
    return (last - first + 1) * alive.any(dim=2)


def ivf_blocks(list_ids, probe, plan) -> str:
    """What the IVF kernel's blocks do on these inputs at ``plan`` (group
    blocks, splits, rows per split): the blocks that score rows, the
    longest block's ring tiles, the groups by size, and the FFMA its
    register tiles issue (8 pairs a warp slice: 8, 16 or 32 a group)
    against those the pairs need."""
    import torch
    from repro_torch.kernels import ops
    gb, _, per = plan
    ids = list_ids.cpu()
    n_lists = ids.shape[0]
    pr = probe.long().cpu().reshape(-1)
    pairs = torch.bincount(pr[(pr >= 0) & (pr < n_lists)],
                           minlength=n_lists)
    span = _ivf_spans(ids, per)
    tiles = -(-span // ops.IVF_TILE)
    groups = -(-pairs // ops.IVF_GROUP)
    with_work, longest = 0, 0
    for z in range(gb):
        handled = (-(-(groups - z) // gb)).clamp(min=0)
        work = tiles * handled[:, None]
        with_work += int((work > 0).sum())
        longest = max(longest, int(work.max()))
    sizes, issued = {}, 0
    rows = span.sum(dim=1)
    for l in range(n_lists):
        n = int(pairs[l])
        for g in range(0, n, ops.IVF_GROUP):
            m = min(ops.IVF_GROUP, n - g)
            width = 8 if m <= 8 else 16 if m <= 16 else 32
            sizes[width] = sizes.get(width, 0) + 1
            issued += int(rows[l]) * width
    live = (ids >= 0).sum(dim=1)
    need = int((live * pairs).sum())
    return (f"{with_work} blocks with rows, the longest {longest} tiles, "
            f"groups by width {dict(sorted(sizes.items()))}, FFMA issued "
            f"{issued / max(1, need):.2f}x those needed")


# ------------------------------------------------------------------ phases


def phase_card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{name}, capability {cap}, count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "name": name}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all(ptxas_verbose=True)
    log(f"build: {len(build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                log(f"  ptxas[{name}] {line.strip()}")
    # tensor-core instructions in each bf16 flash kernel's machine code:
    # the forward's, and the backward's at its 5 head dims
    for lib, kernel, count in (("flash_attention", "flash_mma_kernel", None),
                               ("flash_attention_bwd", "bwd_mma_kernel", 5)):
        per_fn, fn = {}, None
        for line in build.sass(lib).splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                per_fn[fn] = 0
            elif fn is not None and "HMMA" in line:
                per_fn[fn] += 1
        mma = {f: n for f, n in per_fn.items() if kernel in f}
        for f, n in mma.items():
            log(f"  sass[{lib}] {n} HMMA in {f}")
        check(bool(mma) and count in (None, len(mma))
              and all(n > 0 for n in mma.values()),
              f"the bf16 {lib} kernels carry no HMMA instruction: {per_fn}")
    # the top-k and IVF scan kernels' instruction mix: f32 FFMA, shared
    # loads (LDS.128 are the float4 reads of the register tile), cp.async
    for lib, scan in (("topk", "topk_scan_kernel"),
                      ("ivf_topk", "ivf_scan_kernel"),
                      ("topk_list", "topk_list_scan_kernel"),
                      ("topk_select", "select_scan_kernel"),
                      ("ivf_select", "ivf_write_kernel")):
        ops_of, fn = {}, None
        for line in build.sass(lib).splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                ops_of[fn] = {"all": 0, "FFMA": 0, "LDS.128": 0, "LDS": 0,
                              "LDGSTS": 0, "SHFL": 0}
            elif fn is not None:
                m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                              line)
                if m is None:
                    continue
                op = m.group(1)
                ops_of[fn]["all"] += 1
                for key in ("FFMA", "LDGSTS", "SHFL"):
                    if op.split(".")[0] == key:
                        ops_of[fn][key] += 1
                if op.startswith("LDS"):
                    ops_of[fn]["LDS.128" if ".128" in op else "LDS"] += 1
        for f, counts in ops_of.items():
            if scan in f:
                log(f"  sass[{lib}] {f}: {json.dumps(counts)}")


class MainPathInputs:
    """While installed, each kernel wrapper of ``ops`` keeps the inputs
    of its costliest call (by the bytes it must move) and then runs as
    before.  Pools are kept by reference (later writes change their
    contents, not their shapes or what counts); the small per-call
    tensors are cloned."""

    def __init__(self, ops):
        self.ops = ops
        self.best = {}
        self.orig = {name: getattr(ops, name) for name in WRAPPERS}

    def _keep(self, name, work, args, kw):
        if name not in self.best or work[0] > self.best[name][0][0]:
            self.best[name] = (work, args, kw)

    def install(self):
        orig = self.orig

        def paged(q, kp, vp, tb, fi, la, softcap=None):
            args = (q.clone(), kp, vp, tb.clone(), fi.clone(), la.clone())
            self._keep("paged_decode_attention",
                       paged_work(args[0], kp, *args[3:]), args,
                       {"softcap": softcap})
            return orig["paged_decode_attention"](q, kp, vp, tb, fi, la,
                                                  softcap=softcap)

        def flash(q, k, v, qp, kvp, causal=True, window=None, softcap=None):
            kw = {"causal": causal, "window": window, "softcap": softcap}
            self._keep("flash_attention",
                       flash_work(q, k, qp, kvp, causal, window),
                       (q, k, v, qp.clone(), kvp.clone()), kw)
            return orig["flash_attention"](q, k, v, qp, kvp, **kw)

        def topk(q, d, k):
            self._keep("retrieval_topk", topk_work(q, d, k), (q, d, k), {})
            return orig["retrieval_topk"](q, d, k)

        def ivf(q, emb, ids, probe, k):
            self._keep("ivf_retrieval_topk", ivf_work(q, emb, ids, probe, k),
                       (q.clone(), emb, ids, probe.clone(), k), {})
            return orig["ivf_retrieval_topk"](q, emb, ids, probe, k)

        self.ops.paged_decode_attention = paged
        self.ops.flash_attention = flash
        self.ops.retrieval_topk = topk
        self.ops.ivf_retrieval_topk = ivf

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def _rag_setup(n_entities: int):
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.data.tokenizer import Tokenizer
    from repro_torch.retrieval.encoder import TextEncoder
    docs, qas = generate_corpus(n_entities, seed=0)
    tok = Tokenizer.build([d.text for d in docs] + [q.question for q in qas])
    # six distinct questions, then repeats of the 2nd and 3rd: a repeat
    # retrieves the same contexts and forks the cached prefix (the first
    # request opens the frame, which bypasses the prefix cache)
    qs = [qas[i * 7].question for i in range(6)]
    qs += [qs[1], qs[2]]
    return docs, tok, TextEncoder(seed=0), qs


def _rag(cfg, params, docs, tok, enc, device, max_len, chunk, block, batch,
         top_k, new_tokens):
    from repro_torch.rag.pipeline import RAGPipeline
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.serving.engine import ServeEngine
    index = FlatIndex(enc.dim, device=device)
    index.add(enc.encode([d.text for d in docs]), [d.text for d in docs])
    eng = ServeEngine(cfg, params, max_len=max_len, batch_size=batch,
                      prefill_chunk=chunk, paged=True, block_size=block,
                      device=device)
    rag = RAGPipeline(enc, index, eng, tok, top_k=top_k,
                      max_new_tokens=new_tokens)
    return rag, eng


@contextlib.contextmanager
def timed_segments(torch):
    """While open, every decode segment is synchronised and timed:
    yields {"s": seconds in decode segments, "tokens": tokens they
    produced, "by": {model name: [seconds, tokens]}}."""
    from repro_torch.serving.engine import ContinuousSession
    seg = {"s": 0.0, "tokens": 0, "by": {}}
    run_segment = ContinuousSession.run_segment

    def timed_segment(self, drain=False):
        before = int(self.idx.sum())
        t = time.perf_counter()
        events = run_segment(self, drain)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        # idx of finished rows still counts their tokens at this point
        n = int(self.idx.sum()) - before
        seg["s"] += dt
        seg["tokens"] += n
        by = seg["by"].setdefault(self.eng.cfg.name, [0.0, 0])
        by[0] += dt
        by[1] += n
        return events

    ContinuousSession.run_segment = timed_segment
    try:
        yield seg
    finally:
        ContinuousSession.run_segment = run_segment


def phase_slice(torch, card, captured: dict, profile: bool = False,
                traced: list = None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = Model(cfg).init_params(seed=0, device=DEV)
    torch.cuda.synchronize()
    log(f"slice: olmo-1b {cfg.num_layers} layers d{cfg.d_model} "
        f"{cfg.num_heads}x{cfg.resolved_head_dim} ff{cfg.d_ff} vocab "
        f"{cfg.vocab_size} {cfg.dtype}, {cfg.param_count() / 1e9:.2f}B "
        f"params drawn in {time.perf_counter() - t0:.1f} s")
    docs, tok, enc, qs = _rag_setup(40)
    rag, eng = _rag(cfg, params, docs, tok, enc, DEV, max_len=512,
                    chunk=16, block=16, batch=4, top_k=3, new_tokens=16)

    finite = []
    logits_fn = eng.model._logits

    def checked_logits(p, x):
        out = logits_fn(p, x)
        finite.append(torch.isfinite(out).all())
        return out

    eng.model._logits = checked_logits

    # first pass: warms up (cuBLAS handles, allocator) and records each
    # kernel's costliest main-path inputs
    rec = MainPathInputs(ops)
    rec.install()
    try:
        warm = [r.answer for r in rag.answer(qs)]
    finally:
        rec.remove()
    captured.update(rec.best)
    torch.cuda.synchronize()

    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    with timed_segments(torch) as seg:
        ops.reset_launches()
        t0 = time.perf_counter()
        results = rag.answer(qs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    st = rag.last_stats
    check(len(results) == len(qs)
          and [r.question for r in results] == qs, "answers out of order")
    check(all(isinstance(r.answer, str) for r in results), "missing answer")
    check([r.answer for r in results] == warm,
          "two greedy runs of the same questions gave different answers")
    check(all(len(r.contexts) == 3 for r in results), "top-3 contexts")
    check(st.prefix_hits >= 1, f"no prefix hit ({st.prefix_hits})")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    for name in SLICE_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the main path")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tag = f"[{card['smi']}]"
    log(f"slice: {len(results)} answers in {wall:.3f} s wall; prefix hits "
        f"{st.prefix_hits} misses {st.prefix_misses}, refills {st.refills}, "
        f"frames {st.frames}, segments {st.segments}, tokens {st.tokens_out}")
    log(f"slice: mean TTFT {st.ttft_mean * 1e3:.2f} ms {tag}")
    log(f"slice: decode {seg['tokens'] / max(seg['s'], 1e-9):.1f} tokens/s "
        f"({seg['tokens']} tokens in {seg['s']:.3f} s of decode segments) "
        f"{tag}")
    log(f"slice: peak memory {peak:.2f} GiB {tag}")
    log(f"slice: launches on the main path {json.dumps(launches)}")
    for r in results[:3]:
        log(f"  q: {r.question!r} -> {r.answer[:60]!r}")
    if profile:
        traced.extend(profile_slice(torch, rag, qs, tag))
    return launches


def _cluster_setup(n_entities: int):
    """build_cluster's corpus (cluster_serve.py): tokenizer over docs and
    questions, shards partitioned with primaries d % 2 == n, and per
    node two slots of (qid, QAPair) across domains: the second repeats
    two of the first's questions (semantic-cache hits) and each slot
    asks one question twice (a shared-prefix fork)."""
    from repro_torch.data.corpus import DOMAINS, generate_corpus
    from repro_torch.data.partition import partition_edge_data
    from repro_torch.data.tokenizer import Tokenizer
    docs, qas = generate_corpus(n_entities, seed=0)
    tok = Tokenizer.build([d.text for d in docs] + [q.question for q in qas]
                          + ["context question answer <sep>"])
    prim = [[d for d in range(len(DOMAINS)) if d % 2 == n] for n in range(2)]
    shards = partition_edge_data(docs, 2, prim, seed=0)
    step = n_entities + 1            # one question per domain, in turn
    slots = []
    for n in range(2):
        pick = [qas[(step * i + 3 * n) % len(qas)] for i in range(7)]
        s1 = [pick[0], pick[1], pick[2], pick[1]]
        s2 = [pick[0], pick[3], pick[2], pick[4], pick[4]]
        slots.append([list(enumerate(s, start=100 * n + 10 * j))
                      for j, s in enumerate((s1, s2))])
    return tok, shards, slots


def _cluster(cfgs, params, tok, shards, device, **kw):
    """Two federated IVF nodes with semantic caches over the paged
    continuous queue (cluster_serve --index ivf --federated --cache
    --paged); node n serves ``cfgs[n]`` with ``params[n]``."""
    from repro_torch.cluster import LiveEdgeNode, enable_federation
    from repro_torch.retrieval.cache import SemanticQueryCache
    from repro_torch.retrieval.encoder import TextEncoder
    nodes = [LiveEdgeNode(n, cfg.name.removesuffix("-smoke"), cfg,
                          params[n], shards[n], tok, TextEncoder(seed=0),
                          seed=10 * n, index_kind="ivf",
                          cache=SemanticQueryCache(), queue="continuous",
                          paged=True, device=device, **kw)
             for n, cfg in enumerate(cfgs)]
    fed = enable_federation(nodes, fanout=2, n_centroids=8, seed=0)
    return nodes, fed


def _queries(node_slots, j):
    from repro_torch.core.cluster import Query
    from repro_torch.retrieval.encoder import TextEncoder
    enc = TextEncoder(seed=0)
    return [Query(qa.domain, enc.encode([qa.question])[0], qid, qa.question,
                  qa.answer) for qid, qa in node_slots[j]]


def _serve_slots(nodes, slots, slo_s):
    """Both nodes' slots in turn; returns per (slot, node) the answers,
    contexts and sources, and per node its retrieval seconds per slot,
    its kernel launches, its seconds in ``process_slot`` (the card
    synchronised around each slot) and the peak device memory allocated
    while it served."""
    import torch
    from repro_torch.kernels import ops
    out = []
    per = [{"retr": [], "launches": dict.fromkeys(ops.launches, 0),
            "wall": 0.0, "peak": 0} for _ in nodes]
    for j in range(2):
        for n, node in enumerate(nodes):
            qs = _queries(slots[n], j)
            before = node.stats.retrieval_s
            counts = dict(ops.launches)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = node.process_slot(qs, slo_s)
            torch.cuda.synchronize()
            per[n]["peak"] = max(per[n]["peak"],
                                 torch.cuda.max_memory_allocated())
            per[n]["wall"] += time.perf_counter() - t0
            per[n]["retr"].append(node.stats.retrieval_s - before)
            for name, c in ops.launches.items():
                per[n]["launches"][name] += c - counts[name]
            out.append(([(r.qid, r.answer, r.dropped) for r in res],
                        node.last_contexts, node.last_sources))
    return out, per


def layer_split(torch, node, node_slots, slo_s) -> dict:
    """Serve one node's slots once more with the device synchronised
    around every prefill chunk, decode step and recurrent cell: host-clock
    seconds in ``prefill_chunk`` and ``decode_step`` and, inside them, in
    each layer kind's cells ({"prefill": s, "decode": s, ("prefill",
    "mlstm"): s, ...}).  The synchronisations slow the pass; the shares
    are what it is for."""
    model = node.engine.model
    t = {}

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            t[key] = t.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    cell = model._cell

    def timed_cell(p, kind, h, state, mask=None, step=False):
        key = ("decode" if step else "prefill", kind)
        return timed(key, cell)(p, kind, h, state, mask, step)

    model._cell = timed_cell
    model.prefill_chunk = timed("prefill", model.prefill_chunk)
    model.decode_step = timed("decode", model.decode_step)
    try:
        for j in range(2):
            node.process_slot(_queries(node_slots, j), slo_s)
    finally:
        for name in ("_cell", "prefill_chunk", "decode_step"):
            delattr(model, name)
    return t


CLUSTER_MODELS = {}   # the cluster's configs and weights, drawn once


def _cluster_models(torch):
    """The quickstart cluster's configs and seeded weights at published
    width on the card (seeds 0, 1), drawn on first use and shared by the
    cluster and runtime phases."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    if not CLUSTER_MODELS:
        cfgs = [get_config(arch) for arch in CLUSTER_ARCHS]
        t0 = time.perf_counter()
        params = [Model(cfg).init_params(seed=n, device=DEV)
                  for n, cfg in enumerate(cfgs)]
        torch.cuda.synchronize()
        CLUSTER_MODELS.update(cfgs=cfgs, params=params,
                              draw_s=time.perf_counter() - t0)
    return CLUSTER_MODELS["cfgs"], CLUSTER_MODELS["params"]


def phase_cluster(torch, card, captured: dict) -> dict:
    from repro_torch.kernels import ops
    cfgs, params = _cluster_models(torch)
    log(f"cluster: node 0 {cfgs[0].name}, node 1 {cfgs[1].name} "
        f"({cfgs[1].num_layers} layers {'/'.join(cfgs[1].layer_pattern)} "
        f"d{cfgs[1].d_model} {cfgs[1].num_heads}x"
        f"{cfgs[1].resolved_head_dim} vocab {cfgs[1].vocab_size}), "
        f"{cfgs[0].dtype}/{cfgs[1].dtype} params (seeds 0, 1) drawn in "
        f"{CLUSTER_MODELS['draw_s']:.1f} s")
    tok, shards, slots = _cluster_setup(40)
    kw = dict(batch_size=4, max_len=512, prefill_chunk=16, block_size=16,
              top_k=3, max_new_tokens=16)
    slo = 60.0

    finite = []

    def watch(nodes):
        for node in nodes:
            logits_fn = node.engine.model._logits

            def checked(p, x, fn=logits_fn):
                out = fn(p, x)
                finite.append(torch.isfinite(out).all())
                return out
            node.engine.model._logits = checked

    # warm pass: cuBLAS handles, allocator, and the IVF kernel's
    # costliest main-path inputs
    nodes, _ = _cluster(cfgs, params, tok, shards, DEV, **kw)
    rec = MainPathInputs(ops)
    rec.install()
    try:
        t0 = time.perf_counter()
        warm, _ = _serve_slots(nodes, slots, slo)
        torch.cuda.synchronize()
        log(f"cluster: warm pass {time.perf_counter() - t0:.3f} s")
    finally:
        rec.remove()
    captured["ivf_retrieval_topk"] = rec.best["ivf_retrieval_topk"]
    del nodes
    torch.cuda.synchronize()

    nodes, fed = _cluster(cfgs, params, tok, shards, DEV, **kw)
    watch(nodes)
    log(f"cluster: shards of {[len(s) for s in shards]} docs, IVF "
        f"n_lists {[nd.index.n_lists for nd in nodes]} nprobe "
        f"{[nd.index.nprobe for nd in nodes]}")
    with timed_segments(torch) as seg:
        ops.reset_launches()
        t0 = time.perf_counter()
        got, per = _serve_slots(nodes, slots, slo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
    check(got == warm, "the warm and the measured pass gave different "
          "answers, contexts or sources")
    sts = [nd.stats for nd in nodes]
    check(all(st.drops == 0 for st in sts), "a query was dropped")
    check(sum(st.remote_contexts for st in sts) > 0,
          "federation served no remote context")
    check(all(st.cache_hits >= 1 for st in sts), "no semantic-cache hit")
    check(all(st.prefix_hits >= 1 for st in sts), "a node had no prefix "
          "hit (on node 1: no fork from a recurrent-state snapshot)")
    check(bool(torch.stack(finite).all()), "non-finite logits")
    for name in CLUSTER_KERNELS:
        check(launches.get(name, 0) > 0,
              f"kernel {name} was not launched on the cluster path")
    check(per[1]["launches"]["ivf_retrieval_topk"] > 0,
          "node 1 did not launch the IVF probe kernel")
    for name in ("flash_attention", "paged_decode_attention"):
        check(per[1]["launches"][name] == 0,
              f"node 1 ({cfgs[1].name}) launched {name}")
        check(per[0]["launches"][name] > 0, f"node 0 did not launch {name}")
    peak = max(p["peak"] for p in per) / 2 ** 30
    tag = f"[{card['smi']}]"
    nq = sum(st.queries for st in sts)
    log(f"cluster: {nq} queries over 2 nodes x 2 slots in {wall:.3f} s "
        f"wall {tag}")
    for n, st in enumerate(sts):
        name = cfgs[n].name
        s_dec, n_dec = seg["by"].get(name, (0.0, 0))
        log(f"cluster: node {n} ({name}) {per[n]['wall']:.3f} s in its "
            f"slots, retrieval ms per slot "
            f"{[round(1e3 * r, 3) for r in per[n]['retr']]}, mean TTFT "
            f"{st.ttft_mean * 1e3:.2f} ms, {st.queries_per_s:.2f} queries/s "
            f"(retrieval {st.retrieval_s:.3f} s + generate "
            f"{st.generate_s:.3f} s) {tag}")
        log(f"cluster: node {n} ({name}) decode "
            f"{n_dec / max(s_dec, 1e-9):.1f} tokens/s ({n_dec} tokens in "
            f"{s_dec:.3f} s of decode segments), peak memory while it "
            f"served {per[n]['peak'] / 2 ** 30:.2f} GiB {tag}")
        log(f"cluster: node {n} cache hits {st.cache_hits}, prefix hits "
            f"{st.prefix_hits} misses {st.prefix_misses}, refills "
            f"{st.refills}, frames {st.waves}, tokens {st.tokens_out}, "
            f"remote contexts {st.remote_contexts} (gold "
            f"{st.remote_gold})")
        log(f"cluster: node {n} launches {json.dumps(per[n]['launches'])}")
    log(f"cluster: decode {seg['tokens'] / max(seg['s'], 1e-9):.1f} "
        f"tokens/s ({seg['tokens']} tokens in {seg['s']:.3f} s of decode "
        f"segments) {tag}")
    log(f"cluster: {nq / wall:.2f} queries/s over the wall {tag}")
    log(f"cluster: peak memory {peak:.2f} GiB {tag}")
    log(f"cluster: federation {json.dumps(vars(fed.stats))}")
    log(f"cluster: launches on the path {json.dumps(launches)}")

    t = layer_split(torch, nodes[1], slots[1], slo)
    for phase in ("prefill", "decode"):
        total = t.get(phase, 0.0)
        parts = ", ".join(
            f"{kind} {t.get((phase, kind), 0.0):.3f} s "
            f"({100 * t.get((phase, kind), 0.0) / max(total, 1e-9):.1f}%)"
            for kind in ("mlstm", "slstm"))
        log(f"cluster: node 1 {phase} {total:.3f} s in "
            f"{'prefill_chunk' if phase == 'prefill' else 'decode_step'} "
            f"(synchronised pass): {parts} {tag}")
    return launches


RUNTIME_SLO = 1.5        # cluster_serve's --slo default
RUNTIME_SLOTS = 3        # cluster_serve's --slots default
RUNTIME_VOLUME = 12      # queries a slot (uniform trace)


class _CudaTimer:
    """Wraps a callable: CUDA-event milliseconds of each call (the card
    synchronised after it), host milliseconds, and the length of
    positional argument ``size_arg`` when given (a batch size)."""

    def __init__(self, torch, fn, size_arg=None):
        self.torch, self.fn, self.size_arg = torch, fn, size_arg
        self.ms, self.host_ms, self.sizes = [], [], []

    def __call__(self, *args, **kw):
        torch = self.torch
        if self.size_arg is not None:
            self.sizes.append(len(args[self.size_arg]))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        end.synchronize()
        self.host_ms.append(1e3 * (time.perf_counter() - t0))
        self.ms.append(start.elapsed_time(end))
        return out


def _ms(xs) -> str:
    return (f"median {statistics.median(xs):.3f} ms (min {min(xs):.3f}, "
            f"max {max(xs):.3f}, {len(xs)} calls)") if xs else "no calls"


def _watch_runtime(runtime, log_):
    """Keep each slot's assignment and dispatched results in ``log_``."""
    route, dispatch = runtime._route, runtime._dispatch

    def routed(probs, slo_s):
        assign, props = route(probs, slo_s)
        log_.append(("assign", assign.tolist()))
        return assign, props

    def dispatched(queries, assign, slo_s):
        res = dispatch(queries, assign, slo_s)
        log_.append(("results", [(r.qid, r.node, r.answer, r.dropped)
                                 for r in res]))
        return res

    runtime._route, runtime._dispatch = routed, dispatched


def phase_runtime(torch, card) -> dict:
    """The launcher's path (cluster_serve.py): the quickstart cluster at
    published width under ``ClusterRuntime`` (PPO identifier on the card,
    Algorithm 1, metrics with SLO feedback), profiled, then a replay of
    uniform slots; every launch count at 0 just before the replay and
    read just after.  Then the card-vs-CPU parity of the same runtime at
    the smoke config."""
    from repro_torch.cluster import ClusterRuntime, LiveWorkload, \
        replay_trace
    from repro_torch.core import ppo
    from repro_torch.core.identifier import OnlineQueryIdentifier
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.retrieval.encoder import TextEncoder
    cfgs, params = _cluster_models(torch)
    tok, shards, _ = _cluster_setup(40)
    _, qas = generate_corpus(40, seed=0)
    nodes, _ = _cluster(cfgs, params, tok, shards, DEV, batch_size=4,
                        max_len=512, prefill_chunk=16, block_size=16,
                        top_k=3, max_new_tokens=16)
    enc = TextEncoder(seed=0)
    check(enc.dim == 256, f"encoder dim {enc.dim}")
    obs_metrics.registry().reset()
    obs_metrics.enable_metrics()
    tag = f"[{card['smi']}]"
    plain_update = ppo.ppo_update
    try:
        ident = OnlineQueryIdentifier(enc.dim, len(nodes), seed=0,
                                      update_threshold=16, device=DEV)
        runtime = ClusterRuntime(nodes, ident, seed=0, slo_feedback=True)
        t0 = time.perf_counter()
        runtime.initialize()
        torch.cuda.synchronize()
        log(f"runtime: profiled in {time.perf_counter() - t0:.3f} s")
        for node in nodes:
            log(f"runtime: node {node.node_id} ({node.arch}) capacity "
                f"{node.capacity.k:.3f} q/s measured -> C({RUNTIME_SLO:g} s) "
                f"= {node.capacity(RUNTIME_SLO):.2f} queries {tag}")

        identify = _CudaTimer(torch, ident.identify)
        ident.identify = identify
        update = _CudaTimer(torch, plain_update, size_arg=3)
        ppo.ppo_update = update
        route_ms, events = [], []
        route = runtime._route

        def timed_route(probs, slo_s):
            t = time.perf_counter()
            out = route(probs, slo_s)
            route_ms.append(1e3 * (time.perf_counter() - t))
            return out

        runtime._route = timed_route
        _watch_runtime(runtime, events)
        per_node = [dict.fromkeys(ops.launches, 0) for _ in nodes]
        for n, node in enumerate(nodes):
            serve = node.process_slot

            def counted(queries, slo_s, scheduler=None, n=n, serve=serve):
                before = dict(ops.launches)
                out = serve(queries, slo_s, scheduler=scheduler)
                torch.cuda.synchronize()
                for name, c in ops.launches.items():
                    per_node[n][name] += c - before[name]
                return out
            node.process_slot = counted

        firing = []

        def on_slot(t, m):
            now = {str(nid): sorted(mon.firing())
                   for nid, mon in runtime.monitors.items() if mon.firing()}
            firing.append(now)
            load = "/".join(f"{p:.3f}" for p in m.per_node_load)
            log(f"runtime: slot {t} n {m.n_queries} load [{load}] quality "
                f"{m.quality_mean:.4f} drop rate {m.drop_rate:.3f} p50 "
                f"{m.latency_p50:.3f} s p95 {m.latency_p95:.3f} s, ppo "
                f"updates {m.ppo_updates}, firing after the slot "
                f"{json.dumps(now)} {tag}")

        workload = LiveWorkload(qas, enc, seed=2)
        ops.reset_launches()
        t0 = time.perf_counter()
        report = replay_trace(runtime, workload, n_slots=RUNTIME_SLOTS,
                              slo_s=RUNTIME_SLO, base_volume=RUNTIME_VOLUME,
                              trace="uniform", seed=3, on_slot=on_slot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        runtime.close()
    finally:
        obs_metrics.enable_metrics(False)
        ppo.ppo_update = plain_update
    summary = report.summary()
    sent = sum(m.n_queries for m in report.slots)
    answered = sum(len(e[1]) for e in events if e[0] == "results")
    qids = [r[0] for e in events if e[0] == "results" for r in e[1]]
    check(sent == RUNTIME_SLOTS * RUNTIME_VOLUME and answered == sent
          and len(set(qids)) == sent, f"{sent} queries sent, {answered} "
          f"results for {len(set(qids))} distinct queries")
    check(ident.updates_done >= 1 and update.ms,
          "no PPO update ran on the card")
    for n in range(len(nodes)):
        check(per_node[n]["ivf_retrieval_topk"] > 0,
              f"node {n} did not launch ivf_retrieval_topk in the replay")
    for name in ("flash_attention", "paged_decode_attention"):
        check(per_node[0][name] > 0, f"node 0 did not launch {name} in "
              "the replay")
        check(per_node[1][name] == 0, f"node 1 launched {name}")
    check(sum(per_node[n][k] for n in range(len(nodes)) for k in launches)
          == sum(launches.values()),
          "launches outside the nodes' slots in the replay")
    log(f"runtime: {sent} queries in {RUNTIME_SLOTS} slots in {wall:.3f} s "
        f"wall; summary {json.dumps(summary)} {tag}")
    log(f"runtime: identify on the card {_ms(identify.ms)} (host "
        f"{_ms(identify.host_ms)}) {tag}")
    log(f"runtime: ppo_update on the card, one epoch at B "
        f"{sorted(set(update.sizes))}: {_ms(update.ms)} (host "
        f"{_ms(update.host_ms)}; {ident.updates_done} updates x "
        f"{ident.update_epochs} epochs) {tag}")
    log(f"runtime: Algorithm 1 on the host {_ms(route_ms)} {tag}")
    log(f"runtime: firing nodes after each slot {firing}; health "
        f"{json.dumps(runtime.health())}")
    for n, node in enumerate(nodes):
        st = node.stats
        log(f"runtime: node {n} ({node.arch}) {st.queries} queries, "
            f"{st.drops} dropped, {st.shed} shed, mean TTFT "
            f"{st.ttft_mean * 1e3:.2f} ms, launches "
            f"{json.dumps(per_node[n])} {tag}")
    log(f"runtime: launches in the replay {json.dumps(launches)}")
    runtime_parity(torch)
    return launches


RUNNING_STAT_TOL = dict(atol=1e-5, rtol=1e-4)   # the policy's BN stats


def runtime_parity(torch) -> None:
    """The runtime at the smoke config (f32) on the card and on the CPU:
    the same policy (a seed draws it on the CPU), capacities pinned to 2
    and 3 queries (Algorithm 1 inflates and reassigns), the SLO out of
    the way (1e9 s): equal assignments, answers and ppo_updates over a
    replay of 3 slots of 5 queries with a PPO update; after it, the
    parameters within 2 lr per Adam step, the running variances and the
    running means within ``RUNNING_STAT_TOL``, and the probabilities
    within 1e-4 in train mode and in eval mode once the hidden pre-norm
    biases are aligned.  Those biases have a true gradient of 0 (batch
    norm removes them in train mode), so both sides move them by +-lr on
    the sign of rounding noise (tests/test_torch_ppo.py).  Each train
    forward averages its biases into the running means, so the card's
    running means are held, and evaluated, less the drift that the two
    sides' biases at each PPO epoch predict:
    sum over epochs c of 0.1 * 0.9**(epochs after c) * (b_card - b_cpu)."""
    from repro_torch.cluster import ClusterRuntime, LiveWorkload, \
        replay_trace
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import ppo
    from repro_torch.core.identifier import OnlineQueryIdentifier
    from repro_torch.core.inter_node import CapacityFunction
    from repro_torch.data.corpus import generate_corpus
    from repro_torch.models import Model
    from repro_torch.retrieval.encoder import TextEncoder
    tok, shards, _ = _cluster_setup(8)
    _, qas = generate_corpus(8, seed=0)
    cfgs = [get_smoke_config(a, vocab=len(tok)) for a in CLUSTER_ARCHS]
    params_cpu = [Model(cfg).init_params(seed=n, device="cpu")
                  for n, cfg in enumerate(cfgs)]
    enc = TextEncoder(seed=0)
    probe = torch.as_tensor(enc.encode([qa.question for qa in qas[:16]]),
                            dtype=torch.float32)
    runs, biases = {}, {"cuda": [], "cpu": []}
    plain_update = ppo.ppo_update

    def recorded(dev):
        def update(policy, *args, **kw):   # the biases the epoch's train
            biases[dev].append([layer.b.detach().cpu().clone()   # forward
                                for layer in policy.layers[:-1]])  # sees
            return plain_update(policy, *args, **kw)
        return update

    for dev in ("cuda", "cpu"):
        nodes, _ = _cluster(cfgs, [_to_device(p, dev) for p in params_cpu],
                            tok, shards, dev, batch_size=2, max_len=192,
                            prefill_chunk=8, block_size=8, top_k=2,
                            max_new_tokens=6)
        for node, k in zip(nodes, (2e-9, 3e-9)):
            node.capacity = CapacityFunction(k=k, b=0.0, levels=[])
        ident = OnlineQueryIdentifier(enc.dim, 2, seed=0, update_threshold=8,
                                      device=dev)
        rt = ClusterRuntime(nodes, ident, seed=0)
        events = []
        _watch_runtime(rt, events)
        ppo.ppo_update = recorded(dev)
        try:
            report = replay_trace(rt, LiveWorkload(qas, enc, seed=2),
                                  n_slots=3, slo_s=1e9, base_volume=5,
                                  trace="uniform", seed=3)
        finally:
            ppo.ppo_update = plain_update
        runs[dev] = (events, [m.ppo_updates for m in report.slots],
                     [m.per_node_load.tolist() for m in report.slots], ident)
    (ev_g, upd_g, load_g, id_g), (ev_c, upd_c, load_c, id_c) = \
        runs["cuda"], runs["cpu"]
    check(ev_g == ev_c, f"runtime parity: assignments or answers differ "
          f"on card and CPU:\n{ev_g}\n{ev_c}")
    check(upd_g == upd_c and upd_c[-1] >= 1 and load_g == load_c,
          f"runtime parity: ppo_updates {upd_g} / {upd_c}, loads {load_g} "
          f"/ {load_c}")
    steps = id_c.updates_done * id_c.update_epochs
    check(len(biases["cpu"]) == steps and len(biases["cuda"]) == steps,
          f"runtime parity: {len(biases['cuda'])} / {len(biases['cpu'])} "
          f"PPO epochs recorded, {steps} expected")
    par = policy_parity(torch, id_g.policy, id_c.policy, biases, probe,
                        steps, id_c.lr)
    log(f"parity: runtime at the smoke config, card vs CPU: "
        f"{sum(len(e[1]) for e in ev_c if e[0] == 'results')} answers and "
        f"assignments equal over 3 slots, ppo_updates {upd_c}; policies "
        f"after the update, both evaluated on the CPU: {par['text']}")
    check(par["ok"], "runtime parity: the policies after the update differ")


def policy_parity(torch, pol_g, pol_c, biases, probe, steps, lr) -> dict:
    """The card's policy ``pol_g`` against the CPU's ``pol_c`` after
    ``steps`` Adam steps (PPO epochs) from the same policy, both
    evaluated on the CPU on ``probe``: the parameters within 2 lr per
    step, the running variances and the running means (the card's less
    the drift that the two sides' pre-norm biases at each epoch predict,
    ``biases[dev][epoch][layer]``) within ``RUNNING_STAT_TOL``, and the
    probabilities within 1e-4 in train mode and in eval mode once the
    pre-norm biases are aligned.  The probabilities in eval mode as
    trained are reported, not held."""
    import copy
    from repro_torch.core import ppo
    pol_g = copy.deepcopy(pol_g).cpu()
    worst = max(max_err(a, b) for a, b in zip(
        pol_g.state_dict().values(), pol_c.state_dict().values()))

    def probs(policy, train):
        with torch.no_grad():      # on the CPU, on copies (train mode
            return torch.softmax(  # moves the running stats)
                copy.deepcopy(policy)(probe, train=train), dim=-1)

    # train mode normalizes by the batch: the pre-norm biases and the
    # running stats (whose means average those biases in) drop out
    train_err = max_err(probs(pol_g, True), probs(pol_c, True))
    raw_err = max_err(probs(pol_g, False), probs(pol_c, False))
    aligned = copy.deepcopy(pol_g)
    mu_err = var_err = drift = 0.0
    stats_ok = True
    for n, (layer, want) in enumerate(zip(aligned.layers[:-1],
                                          pol_c.layers[:-1])):
        pred = sum((1 - ppo.BN_MOMENTUM) * ppo.BN_MOMENTUM ** (steps - 1 - c)
                   * (biases["cuda"][c][n] - biases["cpu"][c][n])
                   for c in range(steps))
        layer.bn_mu.sub_(pred)           # the card's own, less the drift
        layer.b.data.copy_(want.b.data)
        drift = max(drift, float(pred.abs().max()))
        mu_err = max(mu_err, max_err(layer.bn_mu, want.bn_mu))
        var_err = max(var_err, max_err(layer.bn_var, want.bn_var))
        stats_ok &= bool(torch.allclose(layer.bn_mu, want.bn_mu,
                                        **RUNNING_STAT_TOL)
                         and torch.allclose(layer.bn_var, want.bn_var,
                                            **RUNNING_STAT_TOL))
    eval_err = max_err(probs(aligned, False), probs(pol_c, False))
    text = (f"params max |err| {worst:.3g} (tol {2 * lr * steps:.3g}); "
            f"running means less the bias drift of {steps} epochs (max "
            f"|drift| {drift:.3g}) {mu_err:.3g}, running variances "
            f"{var_err:.3g} (allclose {RUNNING_STAT_TOL}); probabilities in "
            f"train mode {train_err:.3g}, in eval mode with the pre-norm "
            f"biases aligned and the running means less the drift "
            f"{eval_err:.3g} (tol 1e-4 each), in eval mode as trained "
            f"{raw_err:.3g} (not held)")
    ok = worst <= 2 * lr * steps and stats_ok and train_err <= 1e-4 \
        and eval_err <= 1e-4
    return {"ok": ok, "params_err": worst, "text": text}


LAUNCHER_SLOTS = 4       # the CI saturation smoke's --slots
LAUNCHER_VOLUME = 12     # its --per-slot (spike: 4x in slots 2 and 3)
# the README quickstart's cluster command (README.md), and the CI
# saturation smoke (.github/workflows/ci.yml), through the port's CLI
README_ARGS = ["--smoke", "--nodes", "2", "--slots", "2", "--standing",
               "--paged", "--admission", "sjf", "--federated",
               "--metrics-every", "1", "--metrics-port", "0"]
CI_ARGS = ["--smoke", "--nodes", "2", "--slots", "4", "--per-slot", "12",
           "--standing", "--paged", "--trace", "spike", "--metrics-port",
           "0", "--require-healthy-exit"]


def _trace_check(path: Path) -> str:
    """``tools/trace_report.py <path> --check``, run as CI runs it."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "trace_report.py"),
                          str(path), "--check"], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"trace_report --check failed on {path}:\n"
          f"{out.stdout}{out.stderr}")
    return out.stdout.strip()


def phase_launcher(torch, card) -> dict:
    """(a) The slice's path at published width: ``build_cluster`` over
    the cluster phase's bf16 weights with standing paged queues, SJF,
    federated IVF retrieval and semantic caches; tracing on (which also
    feeds the SLO monitors); ``ClusterRuntime`` with SLO feedback,
    profiled; a spike replay with every launch count at 0 just before and
    read just after; ``runtime.close()`` drains the standing sessions.
    (b) The README's and CI's cluster_serve commands through the port's
    ``main`` on the card, each with its own launch counts.  Returns the
    launches of (a) and (b) together."""
    from repro_torch import obs
    from repro_torch.cluster import ClusterRuntime, LiveWorkload, \
        replay_trace
    from repro_torch.kernels import ops
    from repro_torch.launch import cluster_serve
    cfgs, params = _cluster_models(torch)
    tag = f"[{card['smi']}]"
    nodes, qas, _, enc, ident, _ = cluster_serve.build_cluster(
        2, archs=CLUSTER_ARCHS, models=list(zip(cfgs, params)),
        entities=40, index_kind="ivf", federated=True, cache=True,
        queue="standing", paged=True, admission="sjf", batch=4, max_len=512,
        prefill_chunk=16, block_size=16, top_k=3, new_tokens=16, device=DEV)
    check([n.queue_kind for n in nodes] == ["standing"] * 2,
          "build_cluster did not build standing nodes")
    obs.registry().reset()
    rec = obs.enable()
    events, slots, straddled = [], [], []
    per_node = [dict.fromkeys(ops.launches, 0) for _ in nodes]
    try:
        runtime = ClusterRuntime(nodes, ident, seed=0, slo_feedback=True)
        t0 = time.perf_counter()
        runtime.initialize()
        torch.cuda.synchronize()
        log(f"launcher: built and profiled in {time.perf_counter() - t0:.3f}"
            f" s; capacities "
            f"{[round(n.capacity.k, 3) for n in nodes]} q/s {tag}")
        _watch_runtime(runtime, events)
        for n, node in enumerate(nodes):
            serve = node.process_slot

            def counted(queries, slo_s, scheduler=None, n=n, node=node,
                        serve=serve):
                before = dict(ops.launches)
                out = serve(queries, slo_s, scheduler=scheduler)
                torch.cuda.synchronize()
                for name, c in ops.launches.items():
                    per_node[n][name] += c - before[name]
                if node.unfinished():
                    straddled.append((n, node.unfinished()))
                return out
            node.process_slot = counted

        def on_slot(t, m):
            slots.append(m)
            log(f"launcher: slot {t} n {m.n_queries} drop rate "
                f"{m.drop_rate:.3f} p50 {m.latency_p50:.3f} s p95 "
                f"{m.latency_p95:.3f} s load "
                f"[{'/'.join(f'{p:.3f}' for p in m.per_node_load)}] "
                f"firing {m.slo_firing} {tag}")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        replay_trace(runtime, LiveWorkload(qas, enc, seed=2),
                     n_slots=LAUNCHER_SLOTS, slo_s=RUNTIME_SLO,
                     base_volume=LAUNCHER_VOLUME, trace="spike", seed=3,
                     on_slot=on_slot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runtime.close()
        rec.record_metrics(obs.registry().snapshot(),
                           obs.get_tracer().now())
    finally:
        obs.disable()
    unfinished = [n.unfinished() for n in nodes]
    sent = sum(m.n_queries for m in slots)
    qids = [r[0] for e in events if e[0] == "results" for r in e[1]]
    check(unfinished == [0, 0], f"unfinished after close(): {unfinished}")
    check(len(qids) == sent == len(set(qids)), f"{sent} queries sent, "
          f"{len(qids)} results for {len(set(qids))} distinct queries")
    frames = [n.stats.waves for n in nodes]
    check(frames == [1, 1], f"paged frames per node {frames}, want 1 each")
    for n in range(len(nodes)):
        check(per_node[n]["ivf_retrieval_topk"] > 0,
              f"node {n} did not launch ivf_retrieval_topk")
    for name in ("flash_attention", "paged_decode_attention"):
        check(per_node[0][name] > 0, f"node 0 did not launch {name}")
        check(per_node[1][name] == 0, f"node 1 launched {name}")
    path = ROOT / "build" / "trace_launcher.jsonl"
    rec.export_jsonl(str(path))
    verdict = _trace_check(path)
    spans = [e for e in rec.events() if e.get("kind") == "span"]
    by_name = {}
    for e in spans:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) \
            + 1e3 * (e["t1"] - e["t0"])
    log(f"launcher: {sent} queries in {LAUNCHER_SLOTS} spike slots in "
        f"{wall:.3f} s wall; requests straddling a slot "
        f"{straddled or 'none (each slot waits for all of its rids)'}; "
        f"frames {frames}, unfinished after close {unfinished} {tag}")
    for n, node in enumerate(nodes):
        st = node.stats
        log(f"launcher: node {n} ({node.arch}) {st.queries} queries, "
            f"{st.drops} dropped, {st.shed} shed, {st.refills} refills, "
            f"mean TTFT {st.ttft_mean * 1e3:.2f} ms, launches "
            f"{json.dumps(per_node[n])} {tag}")
    log(f"launcher: {len(spans)} spans ({len(rec)} events, {rec.dropped} "
        f"dropped), total ms by name "
        f"{json.dumps({k: round(v, 3) for k, v in sorted(by_name.items())})}")
    log(f"launcher: trace {path.relative_to(ROOT)} "
        f"{path.stat().st_size} bytes; {verdict}")
    log(f"launcher: peak memory in the replay {peak:.2f} GiB {tag}")
    health = runtime.health()
    log(f"launcher: health {health['status']}, firing nodes "
        f"{health['firing_nodes']}")
    log(f"launcher: launches in the replay {json.dumps(launches)}")
    total = dict(launches)
    for label, argv in (("readme", README_ARGS), ("ci", CI_ARGS)):
        path = ROOT / "build" / f"trace_{label}.jsonl"
        buf = io.StringIO()
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                cluster_serve.main(argv + ["--trace-out", str(path)])
        except SystemExit as e:
            check(e.code in (None, 0), f"cluster_serve {label} exited "
                  f"with {e.code!r}")
        finally:
            sys.stdout.write(buf.getvalue())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(ops.launches)
        out = buf.getvalue()
        check("metrics probe: OK" in out,
              f"cluster_serve {label}: the metrics probe did not print OK")
        for name in SLICE_KERNELS:
            check(got.get(name, 0) > 0, f"cluster_serve {label} did not "
                  f"launch {name}")
        log(f"launcher[{label}]: cluster_serve {' '.join(argv)} in "
            f"{wall:.3f} s; {_trace_check(path)}; launches "
            f"{json.dumps(got)} {tag}")
        for name, c in got.items():
            total[name] = total.get(name, 0) + c
    return total


# the port's serve launcher at published width (serve.py's flags; the
# olmo-1b run's buckets are 256 and 128, the xlstm-350m run's exact)
SERVE_ARGS = ["--batch", "4", "--requests", "8", "--new-tokens", "16",
              "--max-len", "512", "--reference"]
SERVE_PROMPT_LEN = {"olmo-1b": 256, "xlstm-350m": 64, "hymba-1.5b": 256,
                    "qwen2-moe-a2.7b": 256, "gemma2-9b": 256,
                    "llama3-8b": 256, "nemotron-4-15b": 256,
                    "qwen3-moe-30b-a3b": 256, "whisper-base": 256}
# the reference's default cluster run (no --paged), and with --queue wave
SERVE_CLI = ["--smoke", "--nodes", "2", "--slots", "3"]
# the non-paged engine's three flash call shapes, in the kernels line
FLASH_SHAPES = ("prefill", "chunk", "decode")


class FlashShapes:
    """While installed, ``ops.flash_attention`` keeps, for each call shape
    of the non-paged engine, the inputs of its largest call (q's elements
    times Sk, the latest on ties; positions cloned, the rest by
    reference) and counts
    the calls: "prefill" (a wave's whole padded prompt, Sq = Sk > 1),
    "chunk" (a chunk over the row's whole buffer, 1 < Sq < Sk) and
    "decode" (Sq 1 over the whole buffer).  With ``heads`` set, only
    calls with that many query heads count (one architecture's); with
    ``window`` set, only calls with that window (one layer kind's).  It
    adds no device work and no synchronisation to the calls it sees."""

    def __init__(self, ops, heads=None, window=None, kinds=FLASH_SHAPES,
                 kind_of=None):
        self.ops, self.orig, self.heads = ops, ops.flash_attention, heads
        self.window = window
        self.best, self.calls = {}, dict.fromkeys(kinds, 0)
        # kind_of(q, k, causal) -> one of ``kinds``, or None to pass the
        # call by (default: the engine's three shapes above)
        self.kind_of = kind_of or _engine_kind

    def install(self):
        orig = self.orig

        def flash(q, k, v, qp, kvp, causal=True, window=None, softcap=None):
            Sk = k.shape[1]
            kind = self.kind_of(q, k, causal)
            kw = {"causal": causal, "window": window, "softcap": softcap}
            if kind is not None and self.heads in (None, q.shape[2]) \
                    and self.window in (None, window):
                self.calls[kind] += 1
                size = q.numel() * Sk
                if kind not in self.best or size >= self.best[kind][0]:
                    self.best[kind] = (size, (q, k, v, qp.clone(),
                                              kvp.clone()), kw)
            return orig(q, k, v, qp, kvp, **kw)

        self.ops.flash_attention = flash

    def remove(self):
        self.ops.flash_attention = self.orig


def _engine_kind(q, k, causal):
    """The non-paged engine's flash call shapes (``FLASH_SHAPES``)."""
    Sq, Sk = q.shape[1], k.shape[1]
    return "decode" if Sq == 1 else "prefill" if Sq == Sk else "chunk"


def _count_launches(ops, fn):
    """``fn()`` with every launch count at 0 just before and read just
    after: (its result, {kernel: launches})."""
    import torch
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.launches)


def _serve_cli(torch, ops, serve, arch, tag, default=False) -> dict:
    """(a) / (b): ``repro_torch.launch.serve`` at ``arch``'s published
    width (bf16), launches counted around ``main``; with ``default`` the
    command names no ``--arch`` (``arch`` must be serve.py's default).
    ``generate`` and ``generate_reference`` must agree on the timed
    wave."""
    from repro_torch.configs import get_config
    if default:
        check(serve._parser().parse_args([]).arch == arch,
              f"serve.py's default arch is not {arch}")
    argv = ([] if default else ["--arch", arch]) \
        + ["--prompt-len", str(SERVE_PROMPT_LEN[arch])] + SERVE_ARGS
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            got, launches = _count_launches(ops, lambda: serve.main(argv))
    finally:
        sys.stdout.write(buf.getvalue())
    wall = time.perf_counter() - t0
    check(got["tokens"] == 8 * 16, f"serve {arch}: {got['tokens']} tokens")
    check(all(len(o) == 16 for o in got["outputs"]), f"serve {arch}: an "
          "output is short")
    check(got["loops_agree"], f"serve {arch}: generate and "
          "generate_reference differ on the timed wave")
    cfg = get_config(arch)
    L = SERVE_PROMPT_LEN[arch]
    # random weights can echo a prompt: how many outputs repeat one token
    prompts = serve.make_prompts(8, L, cfg.vocab_size)
    repeats = sum(len(set(o)) == 1 for o in got["outputs"])
    echoes = sum(o[0] == p[-1] for o, p in zip(got["outputs"], prompts))
    check(launches["paged_decode_attention"] == 0,
          f"serve {arch} launched paged_decode_attention")
    exact = any(kind in ("mlstm", "slstm", "hymba")
                for kind in cfg.layer_pattern)
    want = sorted({L // (1 + i % 3) for i in range(8)}) if exact \
        else sorted({max(8, 1 << (L // (1 + i % 3) - 1).bit_length())
                     for i in range(8)})
    check(sorted(set(got["buckets"])) == want,
          f"serve {arch}: buckets {sorted(set(got['buckets']))}, want {want}")
    attends = any(kind in ("attn", "local", "hymba")
                  for kind in cfg.layer_pattern)
    check((launches["flash_attention"] > 0) == attends,
          f"serve {arch}: {launches['flash_attention']} flash_attention "
          f"launches ({arch} {'has' if attends else 'has no'} attention)")
    log(f"serve[{arch}]: serve.py {' '.join(argv)} in {wall:.3f} s: "
        f"{got['tokens']} tokens, {got['waves']} waves, slot utilization "
        f"{got['slot_utilization']:.4f}, buckets {sorted(set(got['buckets']))}"
        f", queue {got['tokens'] / got['seconds']:.2f} tokens/s incl. "
        f"first calls; one wave: generate {got['generate_tok_s']:.2f} "
        f"tokens/s ({got['generate_s'] * 1e3:.3f} ms), generate_reference "
        f"{got['reference_tok_s']:.2f} tokens/s "
        f"({got['reference_s'] * 1e3:.3f} ms), their tokens equal; "
        f"{repeats} of 8 outputs one repeated token, {echoes} starting with "
        f"their prompt's last token; launches "
        f"{json.dumps(launches)} {tag}")
    return launches


def _replay(torch, ops, nodes, qas, enc, ident, on_node=None):
    """ClusterRuntime with metrics and SLO feedback over ``nodes``,
    profiled, then a replay of RUNTIME_SLOTS uniform slots of
    RUNTIME_VOLUME queries at RUNTIME_SLO, every launch count at 0 just
    before and read just after; ``on_node(n, fn)`` runs node n's
    ``process_slot`` call ``fn`` (a recorder around it).  Returns
    (launches, per-node launches, per-node latencies, per-slot metrics,
    replay wall s, profile s)."""
    from repro_torch.cluster import ClusterRuntime, LiveWorkload, \
        replay_trace
    from repro_torch.obs import metrics as obs_metrics
    obs_metrics.registry().reset()
    obs_metrics.enable_metrics()
    lat = [[] for _ in nodes]
    per_node = [dict.fromkeys(ops.launches, 0) for _ in nodes]
    try:
        runtime = ClusterRuntime(nodes, ident, seed=0, slo_feedback=True)
        t0 = time.perf_counter()
        runtime.initialize()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
        for n, node in enumerate(nodes):
            serve = node.process_slot

            def counted(queries, slo_s, scheduler=None, n=n, serve=serve):
                before = dict(ops.launches)
                run = lambda: serve(queries, slo_s, scheduler=scheduler)
                out = on_node(n, run) if on_node else run()
                torch.cuda.synchronize()
                for name, c in ops.launches.items():
                    per_node[n][name] += c - before[name]
                lat[n].extend(r.latency_s for r in out)
                return out
            node.process_slot = counted
        slots = []
        t0 = time.perf_counter()
        _, launches = _count_launches(ops, lambda: replay_trace(
            runtime, LiveWorkload(qas, enc, seed=2), n_slots=RUNTIME_SLOTS,
            slo_s=RUNTIME_SLO, base_volume=RUNTIME_VOLUME, trace="uniform",
            seed=3, on_slot=lambda t, m: slots.append(m)))
        wall = time.perf_counter() - t0
        runtime.close()
    finally:
        obs_metrics.enable_metrics(False)
    sent = sum(m.n_queries for m in slots)
    check(sent == RUNTIME_SLOTS * RUNTIME_VOLUME == sum(map(len, lat)),
          f"replay: {sent} queries sent, {sum(map(len, lat))} results")
    return launches, per_node, lat, slots, wall, prof_s


def _p95(xs) -> float:
    return statistics.quantiles(xs, n=20)[-1] if len(xs) > 1 \
        else (xs or [0.0])[0]


def _serve_replay(torch, ops, cluster_serve, queue, tag) -> dict:
    """(c): ``build_cluster`` over the cluster phase's published-width
    weights, non-paged (``queue`` continuous or wave), cluster_serve's
    other defaults (max_len 192, prefill chunk 32, batch 4, 8 new
    tokens, top-k 2, flat retrieval): ClusterRuntime with metrics and SLO
    feedback, profiled, then a uniform replay, every launch count at 0
    just before and read just after."""
    cfgs, params = _cluster_models(torch)
    nodes, qas, _, enc, ident, _ = cluster_serve.build_cluster(
        2, archs=CLUSTER_ARCHS, models=list(zip(cfgs, params)), entities=40,
        queue=queue, paged=False, device=DEV)
    check([(n.engine.paged, n.engine.prefill_chunk) for n in nodes]
          == [(False, None if queue == "wave" else 32)] * 2,
          f"build_cluster built {queue} nodes with (paged, chunk) "
          f"{[(n.engine.paged, n.engine.prefill_chunk) for n in nodes]}")
    launches, per_node, lat, slots, wall, prof_s = _replay(
        torch, ops, nodes, qas, enc, ident)
    sent = sum(m.n_queries for m in slots)
    check(launches["paged_decode_attention"] == 0,
          f"{queue} replay launched paged_decode_attention")
    check(per_node[0]["flash_attention"] > 0,
          f"{queue} replay: node 0 did not launch flash_attention")
    check(per_node[1]["flash_attention"] == 0,
          f"{queue} replay: node 1 (xlstm) launched flash_attention")
    check(all(p["retrieval_topk"] > 0 for p in per_node),
          f"{queue} replay: a node did not launch retrieval_topk")
    for t, m in enumerate(slots):
        log(f"serve[{queue}]: slot {t} n {m.n_queries} load "
            f"[{'/'.join(f'{p:.3f}' for p in m.per_node_load)}] drop rate "
            f"{m.drop_rate:.3f} p50 {m.latency_p50:.3f} s p95 "
            f"{m.latency_p95:.3f} s {tag}")
    for n, node in enumerate(nodes):
        st = node.stats
        ttft = (f"mean TTFT {st.ttft_mean * 1e3:.2f} ms" if st.ttft_s else
                "TTFT not recorded (a wave's tokens arrive with the wave)")
        log(f"serve[{queue}]: node {n} ({node.arch}) {st.queries} queries, "
            f"{ttft}, {st.queries_per_s:.3f} queries/s, drop rate "
            f"{st.drops / max(st.queries, 1):.3f}, p95 {_p95(lat[n]):.3f} s, "
            f"{st.waves} {'waves' if queue == 'wave' else 'frames'}, "
            f"{st.refills} refills; capacity {node.capacity.k:.3f} q/s; "
            f"launches {json.dumps(per_node[n])} {tag}")
    log(f"serve[{queue}]: {sent} queries in {RUNTIME_SLOTS} uniform slots in "
        f"{wall:.3f} s wall (profiled in {prof_s:.3f} s); launches "
        f"{json.dumps(launches)} {tag}")
    return launches


def _serve_main(torch, ops, cluster_serve, extra, tag) -> dict:
    """(c): the reference's default cluster command (no --paged), or with
    ``extra`` flags, through the port's ``main`` on the card."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            _, launches = _count_launches(
                ops, lambda: cluster_serve.main(SERVE_CLI + extra))
    finally:
        sys.stdout.write(buf.getvalue())
    out = buf.getvalue()
    check("summary:" in out, f"cluster_serve {extra}: no summary")
    check(launches["paged_decode_attention"] == 0,
          f"cluster_serve {extra} launched paged_decode_attention")
    for name in ("flash_attention", "retrieval_topk"):
        check(launches[name] > 0, f"cluster_serve {extra} did not launch "
              f"{name}")
    log(f"serve[cli]: cluster_serve {' '.join(SERVE_CLI + extra)} in "
        f"{time.perf_counter() - t0:.3f} s; launches {json.dumps(launches)} "
        f"{tag}")
    return launches


def _serve_paths(torch, cfg, params, dev, prompts):
    """The smoke model's greedy tokens on ``dev`` through ``generate``,
    ``generate_reference``, a ``RequestQueue`` and a non-paged
    ``ContinuousQueue`` (batch 2, chunk 8: refills)."""
    from repro_torch.serving import (ContinuousQueue, GenerationParams,
                                     RequestQueue, ServeEngine)
    gp = GenerationParams(max_new_tokens=8)
    eng = ServeEngine(cfg, params, max_len=128, batch_size=4, device=dev)
    out = {"generate": eng.generate(prompts[:4], gen=gp),
           "generate_reference": eng.generate_reference(prompts[:4], gen=gp)}
    q = RequestQueue(eng, gp)
    rids = q.submit_all(prompts)
    res = q.run()
    out["wave"] = [res[r] for r in rids]
    eng = ServeEngine(cfg, params, max_len=128, batch_size=2,
                      prefill_chunk=8, device=dev)
    q = ContinuousQueue(eng, gp)
    rids = q.submit_all(prompts)
    res = q.run()
    out["continuous"] = [res[r] for r in rids]
    out["refills"] = q.stats.refills
    return out


def serve_parity(torch) -> None:
    """(d): the smoke configs (f32) on the card and on the CPU from the
    same weights: every path's greedy tokens equal."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    rng = np.random.default_rng(0)
    for arch in CLUSTER_ARCHS:
        cfg = get_smoke_config(arch)
        prompts = [rng.integers(5, cfg.vocab_size, n).tolist()
                   for n in (37, 9, 20, 3, 64, 14)]
        params_cpu = Model(cfg).init_params(seed=0, device="cpu")
        got = _serve_paths(torch, cfg, _to_device(params_cpu, "cuda"),
                           "cuda", prompts)
        want = _serve_paths(torch, cfg, params_cpu, "cpu", prompts)
        check(got == want, f"serve parity {arch}: card and CPU differ:\n"
              f"{got}\n{want}")
        check(got["generate"] == got["generate_reference"],
              f"serve parity {arch}: generate != generate_reference")
        check(got["refills"] >= 1, f"serve parity {arch}: no refill")
        log(f"serve parity: {arch} smoke ({cfg.num_layers} layers d"
            f"{cfg.d_model}, f32) greedy tokens of generate, "
            f"generate_reference, the wave queue ({len(prompts)} requests) "
            f"and the non-paged continuous queue ({got['refills']} refills) "
            "equal on card and CPU")


def serve_kernels(torch, ops, shapes, rec, card) -> None:
    """(e): ``flash_attention.cu`` against its plain version on the card
    at the non-paged engine's three call shapes, from the serve runs'
    largest calls: kernel, plain and SDPA ms beside the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    rows = []
    for kind in FLASH_SHAPES:
        check(kind in shapes.best, f"no {kind} flash call was recorded")
        _, args, kw = shapes.best[kind]
        q, k, v, qp, kvp = args
        got = ops.flash_attention(*args, **kw)
        want = ref.flash_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"flash {kind}: non-finite")
        valid = (qp >= 0)[:, :, None, None].expand_as(got)
        err, tol = max_err(got, want, valid), tolerance(want)
        pads = int((qp < 0).sum())
        log(f"  flash_attention [serve {kind}] q{tuple(q.shape)} "
            f"k{tuple(k.shape)} {dtype_name(q)}, {pads} pad queries, live "
            f"keys per row {(kvp >= 0).sum(dim=1).tolist()}: valid rows "
            f"max|err| {err:.3e} (tol {tol:.3g}); {shapes.calls[kind]} "
            "calls in the serve runs")
        check(err <= tol, f"flash serve {kind}: {err} > {tol}")
        t_k, t_p, t_l, bnd, by = _flash_times(torch, F, ops, ref, args, kw,
                                              f"serve {kind}", card)
        if kind == "decode":
            # the design not taken: copy the live prefix of the buffer
            # ([:, :cap], cap = one past the last live slot) before the
            # call, as a per-layer, per-step slice would
            cap = int((kvp >= 0).any(dim=0).nonzero().max()) + 1
            t_c = bench_ms(lambda: ops.flash_attention(
                q, k[:, :cap].contiguous(), v[:, :cap].contiguous(), qp,
                kvp[:, :cap].contiguous(), **kw))
            log(f"  flash_attention serve decode over a contiguous copy of "
                f"the first {cap} slots: {t_c:.4f} ms with the copies, "
                f"against {t_k:.4f} ms over the whole buffer [{card['smi']}]")
        rows.append({"shape": kind, "q": list(q.shape), "k": list(k.shape),
                     "launches": shapes.calls[kind], "max_abs_err": err,
                     "ms": t_k, "plain_ms": t_p, "bound_ms": bnd,
                     "bound_by": by, "library_ms": t_l})
    rec.setdefault("flash_attention", {}).setdefault("shapes", []).extend(
        rows)


def phase_serve(torch, card, rec: dict) -> dict:
    """The non-paged serving engine's entry points on the card: (a) / (b)
    serve.py at olmo-1b's and xlstm-350m's published width, (c) the
    non-paged and wave cluster replays over the cluster phase's weights
    and cluster_serve's default and wave commands through ``main``, each
    with its own launch counts; (d) card-vs-CPU parity of every path at
    the smoke configs; (e) the flash kernel at the three shapes.  Returns
    the launches of (a)-(c) together."""
    from repro_torch.kernels import ops
    from repro_torch.launch import cluster_serve, serve
    tag = f"[{card['smi']}]"
    total = {}
    shapes = FlashShapes(ops)
    shapes.install()
    try:
        runs = [lambda a=a: _serve_cli(torch, ops, serve, a, tag)
                for a in CLUSTER_ARCHS]
        runs += [lambda q=q: _serve_replay(torch, ops, cluster_serve, q, tag)
                 for q in ("continuous", "wave")]
        runs += [lambda e=e: _serve_main(torch, ops, cluster_serve, e, tag)
                 for e in ([], ["--queue", "wave"])]
        for run in runs:
            for name, c in run().items():
                total[name] = total.get(name, 0) + c
    finally:
        shapes.remove()
    serve_parity(torch)
    serve_kernels(torch, ops, shapes, rec, card)
    log(f"serve: launches on the paths {json.dumps(total)}")
    return total


# the quickstart's other two node archs (cluster_serve.NODE_ARCHS[2:])
NEW_ARCHS = ("hymba-1.5b", "qwen2-moe-a2.7b")
HYMBA_HEADS = 25           # hymba-1.5b's query heads (its flash calls)
# (b): a hymba wave whose rolling buffer (W 1024) wraps in prefill and
# again in decode
WRAP_LENS, WRAP_MAX_LEN, WRAP_NEW = (1100, 1050), 1536, 24
ARCHS_MODELS = {}          # hymba-1.5b and qwen2-moe-a2.7b weights, drawn once


def _archs_models(torch):
    """The four-node cluster's configs and weights at published width:
    the cluster phase's olmo-1b and xlstm-350m (seeds 0, 1) and
    hymba-1.5b and qwen2-moe-a2.7b drawn here (seeds 2, 3)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfgs, params = _cluster_models(torch)
    if not ARCHS_MODELS:
        t0 = time.perf_counter()
        for n, arch in enumerate(NEW_ARCHS, start=2):
            cfg = get_config(arch)
            ARCHS_MODELS[arch] = (cfg, Model(cfg).init_params(seed=n,
                                                              device=DEV))
        torch.cuda.synchronize()
        ARCHS_MODELS["draw_s"] = time.perf_counter() - t0
    return list(zip(cfgs, params)) + [ARCHS_MODELS[a] for a in NEW_ARCHS]


def archs_wrap(torch, ops, tag) -> FlashShapes:
    """(b): hymba-1.5b at published width (seed 0) over a 1536-slot cache:
    a wave of 1100- and 1050-token prompts (exact-length: one left-padded
    row) fills and wraps the 1024-slot rolling buffer in prefill, and 24
    decode steps wrap it again.  ``generate`` must equal
    ``generate_reference``; the first token must equal the argmax of the
    full-sequence forward at the last prompt position (the same
    operations as the prefill), and the later tokens are held against the
    teacher-forced forward (bf16: an order of summation apart, so a
    near-tie may flip; most must agree).  Returns (the hymba flash calls'
    recorder, the launches of ``generate``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import GenerationParams, ServeEngine
    import numpy as np
    cfg = get_config("hymba-1.5b")
    params = Model(cfg).init_params(seed=0, device=DEV)
    eng = ServeEngine(cfg, params, max_len=WRAP_MAX_LEN, batch_size=2,
                      device=DEV)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(5, cfg.vocab_size, n).tolist() for n in WRAP_LENS]
    gp = GenerationParams(max_new_tokens=WRAP_NEW)
    shapes = FlashShapes(ops, heads=HYMBA_HEADS)
    shapes.install()
    try:
        out, launches = _count_launches(ops, lambda: eng.generate(prompts,
                                                                  gen=gp))
        t0 = time.perf_counter()
        loop = eng.generate_reference(prompts, gen=gp)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
    finally:
        shapes.remove()
    check(out == loop, "hymba wrap: generate != generate_reference")
    check(all(len(o) == WRAP_NEW for o in out), "hymba wrap: short output")
    check(launches["flash_attention"] > 0, "hymba wrap: no flash launch")
    L = max(WRAP_LENS)
    toks = np.zeros((2, L + WRAP_NEW - 1), np.int32)
    pos = np.full(toks.shape, -1, np.int32)
    for i, (p, o) in enumerate(zip(prompts, out)):
        seq = p + o[:-1]
        toks[i, L - len(p):] = seq
        pos[i, L - len(p):] = np.arange(L - len(p), toks.shape[1])
    with torch.no_grad():
        logits = eng.model.forward(params, torch.as_tensor(toks, device=DEV),
                                   torch.as_tensor(pos, device=DEV))
    pred = logits[:, L - 1:].argmax(-1).cpu().numpy()
    got = np.asarray(out)
    check(bool((pred[:, 0] == got[:, 0]).all()),
          f"hymba wrap: first tokens {got[:, 0]} != forward argmax "
          f"{pred[:, 0]}")
    agree = float((pred == got).mean())
    check(agree >= 0.5, f"hymba wrap: only {agree:.3f} of the tokens agree "
          "with the teacher-forced forward")
    log(f"archs[wrap]: hymba-1.5b prompts {list(WRAP_LENS)} (buffer "
        f"{min(cfg.sliding_window, WRAP_MAX_LEN)} slots, window "
        f"{cfg.sliding_window}), {WRAP_NEW} new tokens: generate == "
        f"generate_reference ({t_ref:.3f} s), first tokens = forward argmax, "
        f"{agree:.4f} of {got.size} tokens = teacher-forced forward argmax; "
        f"launches {json.dumps(launches)} {tag}")
    return shapes, launches


def mamba_split(torch, node, queries, slo_s) -> dict:
    """One more slot of ``queries`` on the hymba node with the card
    synchronised around every prefill chunk, decode step and Mamba call:
    host seconds in ``prefill_chunk`` / ``decode_step`` and, inside them,
    in ``mamba_forward`` / ``mamba_step``."""
    from repro_torch.models import ssm
    model = node.engine.model
    t = {}

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            t[key] = t.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    fwd, step = ssm.mamba_forward, ssm.mamba_step
    ssm.mamba_forward = timed("mamba prefill", fwd)
    ssm.mamba_step = timed("mamba decode", step)
    model.prefill_chunk = timed("prefill", model.prefill_chunk)
    model.decode_step = timed("decode", model.decode_step)
    try:
        node.process_slot(queries, slo_s)
    finally:
        ssm.mamba_forward, ssm.mamba_step = fwd, step
        for name in ("prefill_chunk", "decode_step"):
            delattr(model, name)
    return t


def archs_replay(torch, ops, cluster_serve, paged, tag, moe_rec) -> dict:
    """(c): ``build_cluster(4)`` over the four archs' published-width
    weights (olmo-1b, xlstm-350m, hymba-1.5b, qwen2-moe-a2.7b; seeds 0-3),
    paged with the prefix cache or non-paged (the continuous queue),
    cluster_serve's other defaults; ClusterRuntime with SLO feedback,
    profiled, then 3 uniform slots of 12 at SLO 1.5 s, each node's
    launches counted.  The qwen2-moe node's kernel inputs go to
    ``moe_rec`` (a MainPathInputs).  On the paged run, the hymba node's
    Mamba share of prefill (``mamba_split``).  Returns (launches, the
    qwen2-moe node's launches)."""
    label = "paged" if paged else "nonpaged"
    models = _archs_models(torch)
    nodes, qas, _, enc, ident, _ = cluster_serve.build_cluster(
        4, models=models, entities=40, paged=paged, device=DEV)
    check([n.arch for n in nodes] == list(cluster_serve.NODE_ARCHS),
          f"4 nodes of {[n.arch for n in nodes]}")

    def on_node(n, run):
        if n != 3 or moe_rec is None:
            return run()
        moe_rec.install()
        try:
            return run()
        finally:
            moe_rec.remove()

    seg_by = {}
    with timed_segments(torch) as seg:
        launches, per_node, lat, slots, wall, prof_s = _replay(
            torch, ops, nodes, qas, enc, ident, on_node)
        seg_by = dict(seg["by"])
    check(per_node[2]["flash_attention"] > 0,
          f"archs {label}: the hymba node did not launch flash_attention")
    check(per_node[2]["paged_decode_attention"] == 0,
          f"archs {label}: the hymba node launched paged_decode_attention "
          "(its K/V is per-row, not pooled)")
    check(per_node[3]["flash_attention"] > 0,
          f"archs {label}: the qwen2-moe node did not launch flash_attention")
    check((per_node[3]["paged_decode_attention"] > 0) == paged,
          f"archs {label}: the qwen2-moe node launched paged decode "
          f"{per_node[3]['paged_decode_attention']} times")
    check(per_node[1]["flash_attention"] == 0,
          f"archs {label}: node 1 (xlstm) launched flash_attention")
    for t, m in enumerate(slots):
        log(f"archs[{label}]: slot {t} n {m.n_queries} load "
            f"[{'/'.join(f'{p:.3f}' for p in m.per_node_load)}] drop rate "
            f"{m.drop_rate:.3f} p50 {m.latency_p50:.3f} s p95 "
            f"{m.latency_p95:.3f} s {tag}")
    for n, node in enumerate(nodes):
        st = node.stats
        dec = seg_by.get(node.engine.cfg.name, [0.0, 0])
        log(f"archs[{label}]: node {n} ({node.arch}) {st.queries} queries, "
            f"mean TTFT {st.ttft_mean * 1e3:.2f} ms, decode "
            f"{dec[1] / max(dec[0], 1e-9):.2f} tokens/s ({dec[1]} tokens in "
            f"{dec[0]:.3f} s of decode segments), drop rate "
            f"{st.drops / max(st.queries, 1):.3f}, p95 {_p95(lat[n]):.3f} s, "
            f"{st.queries_per_s:.3f} queries/s, {st.waves} frames, "
            f"{st.refills} refills, prefix hits {st.prefix_hits}; capacity "
            f"{node.capacity.k:.3f} q/s; launches {json.dumps(per_node[n])} "
            f"{tag}")
    log(f"archs[{label}]: {sum(m.n_queries for m in slots)} queries in "
        f"{RUNTIME_SLOTS} uniform slots in {wall:.3f} s wall (profiled in "
        f"{prof_s:.3f} s); launches {json.dumps(launches)} {tag}")
    if paged:
        t = mamba_split(torch, nodes[2], _queries_from(qas, enc, 12),
                        RUNTIME_SLO)
        pre, dec = t.get("prefill", 0.0), t.get("decode", 0.0)
        m_pre, m_dec = t.get("mamba prefill", 0.0), t.get("mamba decode", 0.0)
        log(f"archs[{label}]: hymba node, one synchronised slot of 12: "
            f"prefill chunks {pre:.3f} s, Mamba in them {m_pre:.3f} s "
            f"({m_pre / max(pre, 1e-9):.4f} of prefill); decode steps "
            f"{dec:.3f} s, Mamba in them {m_dec:.3f} s "
            f"({m_dec / max(dec, 1e-9):.4f} of decode) {tag}")
    for node in nodes:
        node.close()
    return launches, per_node[3]


def _queries_from(qas, enc, n):
    """The first ``n`` questions as cluster queries (qids 900..)."""
    from repro_torch.core.cluster import Query
    return [Query(qa.domain, enc.encode([qa.question])[0], 900 + i,
                  qa.question, qa.answer) for i, qa in enumerate(qas[:n])]


def _paged_fork_tokens(torch, cfg, params, dev):
    """The smoke model's greedy tokens through the paged continuous queue
    (batch 2, chunk 8, blocks of 8) on a stream that forks one shared
    prefix (a mid-block tail) into three rows."""
    from repro_torch.serving import (ContinuousQueue, GenerationParams,
                                     ServeEngine)
    ctx = [5, 6, 7, 2, 3, 4, 1, 2, 9, 9, 3]
    stream = [([8, 30, 2, 19, 7], 0), (ctx + [14, 4, 1], len(ctx)),
              (ctx + [7, 8, 2, 40], len(ctx)), ([21, 3, 3, 17], 0),
              (ctx + [9, 1, 5], len(ctx))]
    eng = ServeEngine(cfg, params, max_len=128, batch_size=2,
                      prefill_chunk=8, paged=True, block_size=8, device=dev)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=8))
    rids = [q.submit(p, prefix_len=pl) for p, pl in stream]
    res = q.run()
    return [res[r] for r in rids], q.stats.prefix_hits, q.stats.cow_forks


def archs_parity(torch, ops, cluster_serve, tag) -> dict:
    """(d): the smoke configs (f32) of both archs on the card and on the
    CPU from the same weights: greedy tokens of generate,
    generate_reference, the wave queue, the non-paged continuous queue
    and the paged continuous queue with a forked prefix equal; then
    ``cluster_serve --smoke --nodes 4`` on the card (paged, standing),
    its trace through ``trace_report --check``."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    rng = np.random.default_rng(0)
    for arch in NEW_ARCHS:
        cfg = get_smoke_config(arch)
        prompts = [rng.integers(5, cfg.vocab_size, n).tolist()
                   for n in (37, 9, 20, 3, 64, 14)]
        params_cpu = Model(cfg).init_params(seed=0, device="cpu")
        params_gpu = _to_device(params_cpu, "cuda")
        got = _serve_paths(torch, cfg, params_gpu, "cuda", prompts)
        want = _serve_paths(torch, cfg, params_cpu, "cpu", prompts)
        got["paged"] = _paged_fork_tokens(torch, cfg, params_gpu, "cuda")
        want["paged"] = _paged_fork_tokens(torch, cfg, params_cpu, "cpu")
        check(got == want, f"archs parity {arch}: card and CPU differ:\n"
              f"{got}\n{want}")
        check(got["generate"] == got["generate_reference"],
              f"archs parity {arch}: generate != generate_reference")
        check(got["paged"][1] >= 2 and got["paged"][2] >= 1,
              f"archs parity {arch}: prefix hits / forks {got['paged'][1:]}")
        log(f"archs parity: {arch} smoke ({cfg.num_layers} layers d"
            f"{cfg.d_model}, window {cfg.sliding_window}, f32) greedy tokens "
            f"of generate, generate_reference, the wave queue, the non-paged "
            f"continuous queue ({got['refills']} refills) and the paged "
            f"queue ({got['paged'][1]} prefix hits, {got['paged'][2]} "
            f"copy-on-write forks) equal on card and CPU")
    trace = ROOT / "build" / "trace_archs.jsonl"
    trace.parent.mkdir(exist_ok=True)
    argv = ["--smoke", "--nodes", "4", "--slots", "2", "--per-slot", "8",
            "--paged", "--standing", "--trace-out", str(trace)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            _, launches = _count_launches(ops,
                                          lambda: cluster_serve.main(argv))
    finally:
        sys.stdout.write(buf.getvalue())
    out = buf.getvalue()
    check("summary:" in out and "0 request(s) unfinished" in out,
          "cluster_serve --nodes 4: no summary or unfinished requests")
    report = _trace_check(trace)
    for name in ("flash_attention", "paged_decode_attention",
                 "retrieval_topk"):
        check(launches[name] > 0, f"cluster_serve --nodes 4 did not launch "
              f"{name}")
    log(f"archs[cli]: cluster_serve {' '.join(argv)} in "
        f"{time.perf_counter() - t0:.3f} s; trace_report --check: "
        f"{report.splitlines()[-1] if report else ''}; launches "
        f"{json.dumps(launches)} {tag}")
    return launches


def _flash_row(torch, F, ops, ref, args, kw, label, calls, card) -> dict:
    """The flash kernel held against its plain version on ``args`` and
    timed beside it and SDPA: a kernels-line "shapes" row."""
    q, k, v, qp, kvp = args
    got = ops.flash_attention(*args, **kw)
    want = ref.flash_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite")
    valid = (qp >= 0)[:, :, None, None].expand_as(got)
    err, tol = max_err(got, want, valid), tolerance(want)
    log(f"  flash_attention [{label}] q{tuple(q.shape)} k{tuple(k.shape)} "
        f"window {kw.get('window')} {dtype_name(q)}: valid rows max|err| "
        f"{err:.3e} (tol {tol:.3g}); {calls} calls on its path")
    check(err <= tol, f"flash {label}: {err} > {tol}")
    t_k, t_p, t_l, bnd, by = _flash_times(torch, F, ops, ref, args, kw,
                                          label, card)
    return {"shape": label, "q": list(q.shape), "k": list(k.shape),
            "launches": calls, "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": bnd, "bound_by": by, "library_ms": t_l}


def _paged_row(torch, F, ops, ref, args, kw, label, calls, card) -> dict:
    """The paged decode kernel held against its plain version on ``args``
    (rows with no live slot, idle rows of the batch, are unspecified and
    left out) and timed beside it and SDPA over the gathered K/V: a
    kernels-line "shapes" row."""
    got = ops.paged_decode_attention(*args, **kw)
    want = ref.paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    q, kp, _, tb, fi, la = args
    bs = kp.shape[1]
    pos = torch.arange(tb.shape[1] * bs, device=DEV)[None]
    live = ((pos >= fi[:, None]) & (pos <= la[:, None])
            & (tb >= 0).repeat_interleave(bs, 1)).any(dim=1)
    check(bool(live.any()), f"paged decode {label}: no row has a live slot")
    err = max_err(got, want, live[:, None, None].expand_as(got))
    tol = tolerance(want[live])
    log(f"  paged_decode_attention [{label}] q{tuple(q.shape)} "
        f"pool{tuple(kp.shape)} table{tuple(tb.shape)} softcap "
        f"{kw.get('softcap')} {dtype_name(q)}, {int(live.sum())} rows with "
        f"live slots: max|err| {err:.3e} (tol {tol:.3g}); {calls} calls on "
        "the path")
    check(err <= tol, f"paged decode {label}: {err} > {tol}")
    t_k, t_p, t_l, bnd, by = _paged_times(torch, F, ops, ref, args, kw,
                                          label, card)
    return {"shape": label, "q": list(q.shape), "k": list(kp.shape),
            "launches": calls, "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": bnd, "bound_by": by,
            "library_ms": t_l}


def _wrapped_chunk(torch, gen, W=1024, C=16, B=4):
    """hymba's chunk of 16 over a wrapped rolling buffer of 1024 slots:
    row b has absorbed 1100 + 37 b tokens (relative positions from 0), its
    buffer holds the last 1024 of them by ``p % 1024``, the chunk's
    queries follow (the first b columns pads, -1)."""
    from repro_torch.models import cache as cache_lib
    H, KV, hd, bf16 = HYMBA_HEADS, 5, 64, torch.bfloat16
    start = torch.tensor([[1100 + 37 * b] for b in range(B)],
                         dtype=torch.int32, device=DEV)
    past = cache_lib.rolling_kv_positions(start, W)
    cols = torch.arange(C, dtype=torch.int32, device=DEV)[None]
    qp = torch.where(cols >= torch.arange(B, device=DEV)[:, None],
                     start + cols, torch.full_like(cols, -1)).to(torch.int32)
    q = torch.randn(B, C, H, hd, generator=gen, device=DEV).to(bf16)
    k = torch.randn(B, W + C, KV, hd, generator=gen, device=DEV).to(bf16)
    v = torch.randn(B, W + C, KV, hd, generator=gen, device=DEV).to(bf16)
    return q, k, v, qp.contiguous(), torch.cat([past, qp], 1).contiguous()


def archs_kernels(torch, ops, serve_shapes, wrap_shapes, moe_rec,
                  moe_launches, rec, card) -> None:
    """(e): ``flash_attention.cu`` at hymba's shapes (a chunk of 16 over a
    wrapped 1024-slot buffer, the wave prefill [4,256,25,64] of (a), the
    decode read of (b)'s wrapped buffer) and qwen2-moe's paged decode
    and chunk from (c), each against its plain version, timed beside it
    and the library call; their rows join the kernels line's "shapes".
    Then the qwen2-moe MoE layer's time at decode and at a chunk."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    gen = torch.Generator(device=DEV)
    gen.manual_seed(11)
    W = 1024
    rows = [_flash_row(torch, F, ops, ref, _wrapped_chunk(torch, gen, W),
                       {"causal": True, "window": W, "softcap": None},
                       "hymba chunk 16 over a wrapped 1024 buffer", 0, card)]
    for shapes, kind, label in ((serve_shapes, "prefill",
                                 "hymba wave prefill"),
                                (wrap_shapes, "decode",
                                 "hymba decode over the wrapped buffer")):
        check(kind in shapes.best, f"no hymba {kind} flash call recorded")
        _, args, kw = shapes.best[kind]
        rows.append(_flash_row(torch, F, ops, ref, args, kw, label,
                               shapes.calls[kind], card))
    check(rows[1]["q"] == [4, 256, HYMBA_HEADS, 64],
          f"hymba wave prefill recorded at q{rows[1]['q']}")
    check("flash_attention" in moe_rec.best
          and "paged_decode_attention" in moe_rec.best,
          "the qwen2-moe node's kernel inputs were not recorded")
    _, args, kw = moe_rec.best["flash_attention"]
    rows.append(_flash_row(torch, F, ops, ref, args, kw,
                           "qwen2-moe paged chunk",
                           moe_launches["flash_attention"], card))
    rec.setdefault("flash_attention", {}).setdefault("shapes", []).extend(
        rows)
    _, args, kw = moe_rec.best["paged_decode_attention"]
    rec.setdefault("paged_decode_attention", {}).setdefault(
        "shapes", []).append(_paged_row(
            torch, F, ops, ref, args, kw, "qwen2-moe paged decode",
            moe_launches["paged_decode_attention"], card))
    cfg, params = ARCHS_MODELS["qwen2-moe-a2.7b"]
    moe_layer_times(torch, gen, cfg, params["blocks"][0]["moe"],
                    ((4, 1, "decode (4 rows)"), (1, 32, "chunk of 32"),
                     (4, 16, "4 rows x 16"), (4, 256, "wave of 4 x 256")),
                    "qwen2-moe", card)


# a gather of expert weights for a route comparison copies at most this
MOE_GATHER_BYTES = 2.5e9


def moe_layer_times(torch, gen, cfg, p, cases, label, card) -> None:
    """One MoE layer (``p``, dropless as the engine runs it) timed at each
    (B, S, what) of ``cases``, and its expert products alone by each
    route on the same rows, each held to the per-expert products.  The
    bound counts the bytes of the experts this run's routing reaches,
    each read once, beside the sorted-rows route's bytes (it reads every
    expert's weights)."""
    from repro_torch.models import moe
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    cf = float(E)
    expert_bytes = sum(p[w][0].numel() * p[w].element_size()
                       for w in ("wi", "wg", "wo"))
    for B, S, what in cases:
        x = (torch.randn(B, S, cfg.d_model, generator=gen, device=DEV)
             * 0.5).to(p["router"].dtype)
        t = bench_ms(lambda: moe.apply_moe(p, x, cfg, cf), reps=10)
        n = B * S * k
        route = "gathered weights" if n <= moe.MOE_GATHER_MAX else \
            "one bmm a projection over the expert-sorted rows"
        # the expert products alone, by each route on the same rows
        idx, _ = moe.route(p, x, k)
        keep = moe.capacity_keep(idx, E, moe.capacity(S, k, E, cf))
        reached = int(idx.unique().numel())
        bnd = bound_ms(reached * expert_bytes, 6 * n * expert_bytes
                       / p["wi"].element_size() / 3, dtype_name(x))
        line = (f"  {label} MoE layer [{what}] x{tuple(x.shape)}, top-{k} "
                f"of {E}: {t:.4f} ms ({route}); {reached} experts reached, "
                f"bound {bnd[0]:.4f} ms ({bnd[1]}: "
                f"{reached * expert_bytes / 1e9:.3f} GB of their weights; "
                f"the sorted-rows route reads all {E}, "
                f"{E * expert_bytes / 1e9:.3f} GB)")
        xa = x[:, :, None].expand(B, S, k, -1).reshape(n, -1)
        args = (p, xa, idx.reshape(n), keep.reshape(n))
        want = _experts_loop(*args)
        routes = {"sorted-rows bmm": lambda: moe._experts_grouped(*args),
                  "per-expert products": lambda: _experts_loop(*args)}
        if n * expert_bytes <= MOE_GATHER_BYTES:
            routes["gathered weights"] = \
                lambda: moe._experts_gathered(*args[:3])
        parts = []
        for name, fn in routes.items():
            err = max_err(fn(), want)
            check(err <= tolerance(want), f"MoE experts [{what}] {name}: "
                  f"{err} from the per-expert products")
            parts.append(f"{name} {bench_ms(fn, reps=10):.4f} ms")
        log(f"{line}; its experts: {', '.join(parts)} [{card['smi']}]")


def _experts_loop(params, xa, e, keep):
    """The design not taken for a chunk's experts: the kept rows sorted
    by expert, three products for each expert with rows (one host read
    of the counts, ~6 launches an expert)."""
    import torch
    import torch.nn.functional as F
    E = params["wg"].shape[0]
    key = torch.where(keep, e, torch.full_like(e, E))
    key_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(key_s, minlength=E + 1)[:E].tolist()
    xs = xa[order]
    ys = torch.zeros_like(xs)
    off = 0
    for j, c in enumerate(counts):
        if c:
            r = xs[off:off + c]
            ys[off:off + c] = (F.silu(r @ params["wg"][j])
                               * (r @ params["wi"][j])) @ params["wo"][j]
            off += c
    out = torch.empty_like(ys)
    out.index_copy_(0, order, ys)
    return out


def phase_archs(torch, card, rec: dict) -> dict:
    """hymba-1.5b and qwen2-moe-a2.7b on the card: (a) serve.py at both
    archs' published width, (b) a hymba wave that wraps its rolling
    buffer, (c) the 4-node cluster replay paged and non-paged, each with
    its own launch counts, (d) card-vs-CPU parity at the smoke configs
    and cluster_serve --smoke --nodes 4, (e) the kernels at the archs'
    shapes and the MoE layer's time.  Returns the launches of (a)-(d)
    together."""
    from repro_torch.kernels import ops
    from repro_torch.launch import cluster_serve, serve
    tag = f"[{card['smi']}]"
    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    serve_shapes = FlashShapes(ops, heads=HYMBA_HEADS)
    serve_shapes.install()
    try:
        for arch in NEW_ARCHS:
            add(_serve_cli(torch, ops, serve, arch, tag))
    finally:
        serve_shapes.remove()
    wrap_shapes, launches = archs_wrap(torch, ops, tag)
    add(launches)
    models = _archs_models(torch)
    log(f"archs: 4 nodes {[c.name for c, _ in models]}, "
        f"{sum(c.param_count() for c, _ in models) / 1e9:.2f}B params "
        f"(hymba-1.5b and qwen2-moe-a2.7b drawn in "
        f"{ARCHS_MODELS['draw_s']:.1f} s)")
    moe_rec = MainPathInputs(ops)
    for paged in (True, False):
        launches, moe_launches = archs_replay(
            torch, ops, cluster_serve, paged, tag, moe_rec if paged else None)
        add(launches)
        if paged:
            moe_paged = moe_launches
    add(archs_parity(torch, ops, cluster_serve, tag))
    archs_kernels(torch, ops, serve_shapes, wrap_shapes, moe_rec, moe_paged,
                  rec, card)
    for arch in NEW_ARCHS:
        ARCHS_MODELS.pop(arch)
    torch.cuda.empty_cache()
    log(f"archs: launches on the paths {json.dumps(total)}")
    return total


def free_models(torch) -> None:
    """Release a model's weights before the next is drawn: engines,
    queues and sessions hold them in reference cycles, so collect those
    first."""
    gc.collect()
    torch.cuda.empty_cache()


# the dense decoders (ROADMAP A4), gemma2-9b first: serve.py's default
DENSE_ARCHS = ("gemma2-9b", "llama3-8b", "nemotron-4-15b")
# (b): a gemma2 wave whose 4096-slot local buffer wraps in prefill and
# again in decode (the global layers' 4352-slot buffers do not)
DENSE_WRAP_LENS, DENSE_WRAP_MAX_LEN, DENSE_WRAP_NEW = (4200, 4150), 4352, 24
# (c): the paged continuous queue at published width, batch 4 (decode
# reads q [4, H, hd]), chunks of 32, blocks of 16, the prefix cache on
DENSE_QUEUE = dict(max_len=768, batch_size=4, prefill_chunk=32, paged=True,
                   block_size=16)
DENSE_NEW = 16
# (c): where the queue's tokens first part from the solo run's, both
# tokens must lie within this of the top logit of the full forward over
# the common prefix (a near-tie): the two paths compute the same bf16
# model with other kernels and another order of summation (chunks of 32
# against one left-padded prefill, the paged kernel against flash at one
# query), which moves a logit by ~1e-2 after 32-42 layers
NEAR_TIE = 0.25


def _features_logits(torch, model, params, toks, pos, cols):
    """The full-sequence forward's logits at columns ``cols`` only (the
    head over every column of a long wave would be [B, S, 256000] f32);
    an encoder-decoder model attends to the engines' zero frames."""
    cfg = model.cfg
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.zeros((len(toks), cfg.encoder_seq_len, cfg.d_model),
                             device=DEV)
    with torch.no_grad():
        feats = model.forward(params, torch.as_tensor(toks, device=DEV),
                              torch.as_tensor(pos, device=DEV),
                              return_features=True, encoder_frames=frames)
        return model.head(params, feats[:, cols]).float()


def dense_wrap(torch, ops, cfg, params, tag):
    """(b): gemma2-9b at published width over a 4352-slot cache: a wave of
    4200- and 4150-token prompts (bucket 4328, left pads 128 and 178)
    fills and wraps the local layers' 4096-slot buffers in prefill, and
    24 decode steps wrap them again; the global layers' 4352-slot buffers
    hold every position.  ``generate`` must equal ``generate_reference``;
    the first token must equal the argmax of the full-sequence forward at
    the last prompt position and most later ones the teacher-forced
    forward's (the head applied at the 24 compared columns only).
    Returns (the local decode calls' recorder, the launches of
    ``generate``)."""
    import numpy as np
    from repro_torch.models import cache as cache_lib
    from repro_torch.serving import GenerationParams, ServeEngine
    eng = ServeEngine(cfg, params, max_len=DENSE_WRAP_MAX_LEN, batch_size=2,
                      device=DEV)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(5, cfg.vocab_size, n).tolist()
               for n in DENSE_WRAP_LENS]
    gp = GenerationParams(max_new_tokens=DENSE_WRAP_NEW)
    L = eng.prompt_bucket(max(DENSE_WRAP_LENS), DENSE_WRAP_NEW)
    W = cache_lib.rolling_len(cfg, DENSE_WRAP_MAX_LEN)
    check(W == cfg.sliding_window < L and L + DENSE_WRAP_NEW - 1
          <= DENSE_WRAP_MAX_LEN, f"gemma2 wrap: bucket {L}, buffer {W}")
    shapes = FlashShapes(ops, heads=cfg.num_heads, window=cfg.sliding_window)
    shapes.install()
    try:
        t0 = time.perf_counter()
        out, launches = _count_launches(ops, lambda: eng.generate(prompts,
                                                                  gen=gp))
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        loop = eng.generate_reference(prompts, gen=gp)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
    finally:
        shapes.remove()
    check(out == loop, "gemma2 wrap: generate != generate_reference")
    check(all(len(o) == DENSE_WRAP_NEW for o in out),
          "gemma2 wrap: short output")
    check(launches["flash_attention"] > 0
          and launches["paged_decode_attention"] == 0,
          f"gemma2 wrap: launches {launches}")
    check(shapes.calls["decode"] > 0 and shapes.best["decode"][1][1].shape[1]
          == W, "gemma2 wrap: no local decode over the 4096-slot buffer")
    toks = np.zeros((2, L + DENSE_WRAP_NEW - 1), np.int32)
    pos = np.full(toks.shape, -1, np.int32)
    for i, (p, o) in enumerate(zip(prompts, out)):
        toks[i, L - len(p):] = p + o[:-1]
        pos[i, L - len(p):] = np.arange(L - len(p), toks.shape[1])
    pred = _features_logits(torch, eng.model, params, toks, pos,
                            slice(L - 1, None)).argmax(-1).cpu().numpy()
    got = np.asarray(out)
    check(bool((pred[:, 0] == got[:, 0]).all()),
          f"gemma2 wrap: first tokens {got[:, 0]} != forward argmax "
          f"{pred[:, 0]}")
    agree = float((pred == got).mean())
    check(agree >= 0.5, f"gemma2 wrap: only {agree:.3f} of the tokens agree "
          "with the teacher-forced forward")
    log(f"dense[wrap]: gemma2-9b prompts {list(DENSE_WRAP_LENS)} (bucket "
        f"{L}; local buffers {W} slots, window {cfg.sliding_window}, "
        f"positions up to {L + DENSE_WRAP_NEW - 1}: wrapped in prefill and "
        f"decode; global buffers {DENSE_WRAP_MAX_LEN} slots), "
        f"{DENSE_WRAP_NEW} new tokens: generate {t_gen:.3f} s == "
        f"generate_reference {t_ref:.3f} s, first tokens = forward argmax, "
        f"{agree:.4f} of {got.size} tokens = teacher-forced forward argmax; "
        f"launches {json.dumps(launches)} {tag}")
    return shapes, launches


def _dense_stream(vocab):
    """(c)'s requests: (prompt, budget, prefix_len).  A 300-token context
    shared by four requests (the first opens the frame with it; the
    refills miss once, then fork it), and plain requests of other
    lengths, budgets from 6 to 16: rows finish apart, so later requests
    are admitted by refill."""
    import numpy as np
    rng = np.random.default_rng(7)
    ctx = rng.integers(5, vocab, 300).tolist()
    q = [rng.integers(5, vocab, n).tolist() for n in (9, 14, 5, 21)]
    plain = [rng.integers(5, vocab, n).tolist() for n in (40, 130, 77)]
    return [(ctx + q[0], 16, 300), (plain[0], 6, 0), (plain[1], 12, 0),
            (plain[2], 8, 0), (ctx + q[1], 16, 300), (ctx + q[2], 10, 300),
            (ctx + q[3], 14, 300)]


def dense_queue(torch, ops, cfg, params, tag, stream=None,
                shapes=None) -> tuple:
    """(c): the paged ``ContinuousQueue`` with the prefix cache at
    published width (``DENSE_QUEUE``) over ``stream`` (default
    ``_dense_stream``), each request held to a solo
    ``generate_reference`` run on the card (``_hold_to_solo``).  Flash
    calls are recorded by ``shapes`` (default: this arch's calls by the
    engine's shapes).
    Returns (the path's launches, its paged decode's costliest inputs,
    its flash calls by shape)."""
    from repro_torch.serving import (ContinuousQueue, GenerationParams,
                                     ServeEngine)
    stream = stream or _dense_stream(cfg.vocab_size)
    eng = ServeEngine(cfg, params, device=DEV, **DENSE_QUEUE)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=DENSE_NEW))
    rec = MainPathInputs(ops)        # the paged decode's costliest call
    rec.install()
    shapes = shapes or FlashShapes(ops, heads=cfg.num_heads)
    shapes.install()
    try:
        t0 = time.perf_counter()
        res, launches = _count_launches(ops, lambda: (
            [q.submit(p, b, prefix_len=pl) for p, b, pl in stream],
            q.run()))
        wall = time.perf_counter() - t0
    finally:
        shapes.remove()
        rec.remove()
    rids, outs = res
    st = q.stats
    check(st.refills >= 1 and st.prefix_hits >= 1 and st.cow_forks >= 1,
          f"dense queue {cfg.name}: refills {st.refills}, prefix hits "
          f"{st.prefix_hits}, forks {st.cow_forks}")
    for name in ("paged_decode_attention", "flash_attention"):
        check(launches[name] > 0, f"dense queue {cfg.name}: no {name}")
    equal, parted = _hold_to_solo(torch, cfg, params, [
        (rid, outs[rid], p, b) for rid, (p, b, _) in zip(rids, stream)],
        f"dense queue {cfg.name}")
    log(f"dense[queue]: {cfg.name} paged queue ({len(stream)} requests, "
        f"batch {DENSE_QUEUE['batch_size']}, chunk "
        f"{DENSE_QUEUE['prefill_chunk']}) in {wall:.3f} s: {st.refills} "
        f"refills, {st.prefix_hits} prefix hits, {st.cow_forks} "
        f"copy-on-write forks; {equal} of {len(stream)} requests equal "
        f"their solo generate_reference tokens, parted (request, token, "
        f"the solo and the queue token's distance below the forward's top "
        f"logit): {parted}; launches {json.dumps(launches)} {tag}")
    return launches, rec, shapes


def _hold_to_solo(torch, cfg, params, runs, label) -> tuple:
    """Each (rid, tokens, prompt, budget) of ``runs`` against a solo
    ``generate_reference`` run of its prompt on the card (max_len
    ``DENSE_QUEUE``'s): equal, or first parting where both tokens lie
    within ``NEAR_TIE`` of the top logit of the forward over the common
    prefix.  Returns (how many equal, [(rid, token, the solo and the
    queue token's distance below the top logit)] of the partings)."""
    import numpy as np
    from repro_torch.serving import GenerationParams, ServeEngine
    solo = ServeEngine(cfg, params, max_len=DENSE_QUEUE["max_len"],
                       batch_size=1, device=DEV)
    equal, parted = 0, []
    for rid, ours, p, b in runs:
        want = solo.generate_reference([p], gen=GenerationParams(
            max_new_tokens=b))[0]
        check(len(ours) == b, f"{label}: {len(ours)} tokens for a budget "
              f"of {b}")
        if ours == want:
            equal += 1
            continue
        # the first token where they part: both must lie within NEAR_TIE
        # of the top logit of the full forward over the common prefix
        t = next(i for i, (x, y) in enumerate(zip(ours, want)) if x != y)
        seq = np.asarray([p + want[:t]], np.int32)
        pos = np.arange(seq.shape[1], dtype=np.int32)[None]
        lg = _features_logits(torch, solo.model, params, seq, pos,
                              [seq.shape[1] - 1])[0, 0]
        top = float(lg.max())
        below = (top - float(lg[want[t]]), top - float(lg[ours[t]]))
        parted.append((rid, t, round(below[0], 4), round(below[1], 4)))
        check(max(below) <= NEAR_TIE, f"{label}: request {rid} parts from "
              f"its solo run at token {t} ({ours[t]} against {want[t]}), "
              f"{below[1]:.4f} and {below[0]:.4f} below the forward's top "
              "logit")
    return equal, parted


def _standing_tokens(torch, cfg, params, dev):
    """The smoke model's greedy tokens through a paged standing queue:
    two slots, a request straddling the slot boundary mid-decode."""
    from repro_torch.serving import (ContinuousQueue, GenerationParams,
                                     ServeEngine)
    eng = ServeEngine(cfg, params, max_len=96, batch_size=2, prefill_chunk=8,
                      paged=True, block_size=16, device=dev)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=8),
                        standing=True)
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8, 9], [11, 12, 13, 14],
               [3, 1, 4, 1, 5], [9, 2, 6]]
    budgets = [6, 2, 8, 4, 5]
    rids = [q.submit(p, b) for p, b in zip(prompts[:2], budgets)]
    q.run(wait_for=rids)
    rids += [q.submit(p, b) for p, b in zip(prompts[2:4], budgets[2:4])]
    q.run(wait_for=rids[3:])
    straddled = rids[2] in q.unfinished()
    rids.append(q.submit(prompts[4], budgets[4]))
    q.run(wait_for=rids)
    q.close()
    return [q.result(r).tokens for r in rids], straddled


def dense_parity(torch) -> None:
    """(d): the smoke configs (f32, gemma2's window 16: its local buffer
    wraps) on the card and on the CPU from the same weights: greedy
    tokens of generate, generate_reference, the wave queue, the non-paged
    continuous queue, the paged queue with a forked prefix and the paged
    standing queue equal."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    rng = np.random.default_rng(0)
    for arch in DENSE_ARCHS:
        smoke_parity(torch, get_smoke_config(arch), arch, "dense", rng)


def smoke_parity(torch, cfg, label, phase, rng) -> None:
    """The smoke model ``cfg`` (f32) on the card and on the CPU from the
    same weights: greedy tokens of generate, generate_reference, the wave
    queue, the non-paged continuous queue, the paged queue with a forked
    prefix and the paged standing queue equal."""
    from repro_torch.models import Model
    prompts = [rng.integers(5, cfg.vocab_size, n).tolist()
               for n in (37, 9, 20, 3, 64, 14)]
    params_cpu = Model(cfg).init_params(seed=0, device="cpu")
    params_gpu = _to_device(params_cpu, "cuda")
    got = _serve_paths(torch, cfg, params_gpu, "cuda", prompts)
    want = _serve_paths(torch, cfg, params_cpu, "cpu", prompts)
    for key, fn in (("paged", _paged_fork_tokens),
                    ("standing", _standing_tokens)):
        got[key] = fn(torch, cfg, params_gpu, "cuda")
        want[key] = fn(torch, cfg, params_cpu, "cpu")
    check(got == want, f"{phase} parity {label}: card and CPU differ:\n"
          f"{got}\n{want}")
    check(got["generate"] == got["generate_reference"],
          f"{phase} parity {label}: generate != generate_reference")
    check(got["paged"][1] >= 2 and got["paged"][2] >= 1
          and got["standing"][1],
          f"{phase} parity {label}: prefix hits / forks {got['paged'][1:]}"
          f", straddled {got['standing'][1]}")
    log(f"{phase} parity: {label} smoke ({cfg.num_layers} layers d"
        f"{cfg.d_model}, hd {cfg.resolved_head_dim}, window "
        f"{cfg.sliding_window}, f32) greedy tokens of generate, "
        f"generate_reference, the wave queue, the non-paged continuous "
        f"queue ({got['refills']} refills), the paged queue "
        f"({got['paged'][1]} prefix hits, {got['paged'][2]} "
        f"copy-on-write forks) and the paged standing queue (a request "
        f"straddling a slot) equal on card and CPU")


def dense_kernels(torch, ops, wrap_shapes, queue_recs, queue_launches, rec,
                  card) -> None:
    """(e): the paged decode kernel at the three archs' queue decodes
    (gemma2 q [4,16,256] with softcap 50, G 2; llama3 [4,32,128], G 4;
    nemotron [4,48,128], G 6 on the GT-8 instance) and the flash kernel
    at hd 256 (gemma2's paged chunk of 32 with softcap 50, and the local
    decode at Sq 1 over (b)'s wrapped 4096-slot buffer), each against its
    plain version, timed beside it and SDPA (no softcap form); their rows
    join the kernels line's "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    want_q = {"gemma2-9b": [4, 16, 256], "llama3-8b": [4, 32, 128],
              "nemotron-4-15b": [4, 48, 128]}
    paged_rows = []
    for arch in DENSE_ARCHS:
        r = queue_recs[arch][0]
        check("paged_decode_attention" in r.best,
              f"{arch}: the queue's paged decode inputs were not recorded")
        _, args, kw = r.best["paged_decode_attention"]
        check(list(args[0].shape) == want_q[arch]
              and args[1].shape[2] == 8, f"{arch} paged decode recorded at "
              f"q{list(args[0].shape)} pool{list(args[1].shape)}")
        check(kw.get("softcap") == (50.0 if arch == "gemma2-9b" else None),
              f"{arch} paged decode softcap {kw.get('softcap')}")
        paged_rows.append(_paged_row(
            torch, F, ops, ref, args, kw, f"{arch} paged decode",
            queue_launches[arch]["paged_decode_attention"], card))
    rec.setdefault("paged_decode_attention", {}).setdefault(
        "shapes", []).extend(paged_rows)
    g = queue_recs["gemma2-9b"][1]
    check("chunk" in g.best, "no gemma2 chunk was recorded")
    _, args, kw = g.best["chunk"]
    check(args[0].shape[1] == DENSE_QUEUE["prefill_chunk"]
          and args[0].shape[3] == 256 and kw.get("softcap") == 50.0,
          f"gemma2 chunk recorded at q{list(args[0].shape)} {kw}")
    rows = [_flash_row(torch, F, ops, ref, args, kw,
                       "gemma2 paged chunk of 32, hd 256", g.calls["chunk"],
                       card)]
    _, args, kw = wrap_shapes.best["decode"]
    rows.append(_flash_row(torch, F, ops, ref, args, kw,
                           "gemma2 local decode over a wrapped 4096 buffer",
                           wrap_shapes.calls["decode"], card))
    rec.setdefault("flash_attention", {}).setdefault("shapes", []).extend(
        rows)


def phase_dense(torch, card, rec: dict) -> dict:
    """llama3-8b, gemma2-9b and nemotron-4-15b on the card, one model at a
    time (bf16 at published width, freed before the next): (a) serve.py
    with no --arch (gemma2-9b) and with each other arch; (b) a gemma2
    wave that wraps its local buffers; (c) the paged queue with the
    prefix cache against solo runs, each with its own launch counts; (d)
    card-vs-CPU parity at the smoke configs; (e) the kernels at the
    archs' shapes.  Returns the launches of (a)-(d) together."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model
    tag = f"[{card['smi']}]"
    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    queue_recs, queue_launches = {}, {}
    for arch in DENSE_ARCHS:
        add(_serve_cli(torch, ops, serve, arch, tag,
                       default=arch == "gemma2-9b"))
        free_models(torch)
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = Model(cfg).init_params(seed=0, device=DEV)
        torch.cuda.synchronize()
        log(f"dense: {arch} {cfg.param_count() / 1e9:.2f}B params drawn in "
            f"{time.perf_counter() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
            f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if arch == "gemma2-9b":
            wrap_shapes, launches = dense_wrap(torch, ops, cfg, params, tag)
            add(launches)
        launches, *queue_recs[arch] = dense_queue(torch, ops, cfg, params,
                                                  tag)
        queue_launches[arch] = launches
        add(launches)
        del params        # the recorders keep only the pools they read
        free_models(torch)
    dense_parity(torch)
    dense_kernels(torch, ops, wrap_shapes, queue_recs, queue_launches, rec,
                  card)
    del queue_recs, wrap_shapes
    free_models(torch)
    log(f"dense: launches on the paths {json.dumps(total)}")
    return total


# qwen3-moe-30b-a3b and qwen2-vl-72b (ROADMAP A4)
QWEN3, QWEN_VL = "qwen3-moe-30b-a3b", "qwen2-vl-72b"
# (b): qwen2-vl-72b's bf16 weights (~145 GB) do not fit one card; it runs
# at the deepest whole number of layers that leaves this much of the
# card beside its weights (the cache, activations, the allocator's
# slack) and the f32 draw of its largest weight (the LM head)
VL_RESERVE_BYTES = 16 * 2 ** 30
VL_GRID = 16            # the stub frontend's 256 patches: a 16 x 16 image
VL_TEXT = 40            # text tokens after the patches, each row
VL_DECODE = 8           # greedy tokens after the prefill


def _k8(cfg):
    """qwen3's published routing, 128 experts top-8, on a smoke config."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=128, num_experts_per_tok=8))


def vl_positions(torch, B, Nv, S, dev):
    """M-RoPE's [3, B, Nv + S] t/h/w positions: t counts every column,
    patch i sits at row i // VL_GRID and column i % VL_GRID of the image
    (its h and w), text tokens have h = w = t."""
    t = torch.arange(Nv + S, dtype=torch.int32)
    h, w = t.clone(), t.clone()
    h[:Nv], w[:Nv] = t[:Nv] // VL_GRID, t[:Nv] % VL_GRID
    return torch.stack([t, h, w])[:, None].expand(3, B, Nv + S) \
        .contiguous().to(dev)


def vl_depth(torch, cfg) -> int:
    """The deepest whole number of qwen2-vl layers whose bf16 weights, the
    embedding and head, the head's f32 draw and ``VL_RESERVE_BYTES`` fit
    the card's memory."""
    one = dataclasses.replace(cfg, num_layers=1).param_count()
    per_layer = dataclasses.replace(cfg, num_layers=2).param_count() - one
    embed = one - per_layer                 # embedding + LM head
    total = torch.cuda.get_device_properties(0).total_memory
    # bf16 embedding and head (2 bytes a parameter), and the head's f32
    # draw (4 bytes for each of its embed / 2 parameters)
    return int((total - VL_RESERVE_BYTES - 4 * embed) // (2 * per_layer))


def _draw(torch, cfg, what, phase="qwen"):
    """``cfg``'s weights (seed 0) on the card, with the memory it took."""
    from repro_torch.models import Model
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init_params(seed=0, device=DEV)
    torch.cuda.synchronize()
    log(f"{phase}: {what} {cfg.param_count() / 1e9:.2f}B params drawn in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return params


def _serve_smoke(torch, ops, serve, arch, tag) -> dict:
    """serve.py --arch ``arch`` --smoke on the card (f32, d 256), launches
    counted around ``main``."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            got, launches = _count_launches(ops, lambda: serve.main(
                ["--arch", arch, "--smoke"]))
    finally:
        sys.stdout.write(buf.getvalue())
    check(got["tokens"] == 8 * 16 and all(len(o) == 16
                                          for o in got["outputs"]),
          f"serve {arch} --smoke: {got['tokens']} tokens")
    check(launches["flash_attention"] > 0
          and launches["paged_decode_attention"] == 0,
          f"serve {arch} --smoke: launches {launches}")
    log(f"qwen[serve]: serve.py --arch {arch} --smoke: {got['tokens']} "
        f"tokens, {got['waves']} waves; launches {json.dumps(launches)} "
        f"{tag}")
    return launches


def qwen_vision(torch, ops, cfg, params, tag):
    """(b): qwen2-vl's stub frontend at published width: a prefill of 2
    rows of 256 patch embeddings and VL_TEXT tokens at t/h/w positions
    that differ over the patches, then greedy decode steps.  The prefill's
    logits must agree with the full forward's at the last prompt column
    within NEAR_TIE, the h/w positions must move them by more than that,
    and each greedy token must equal the argmax of the teacher-forced
    forward or part from it at a near-tie.  Returns (the path's flash
    calls by shape, its launches)."""
    import numpy as np
    from repro_torch.models import Model
    model = Model(cfg)
    B, Nv, S = 2, cfg.num_vision_tokens, VL_TEXT
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    dt = params["embed"].dtype
    vis = (torch.randn(B, Nv, cfg.d_model, generator=gen, device=DEV)
           * 0.02).to(dt)          # patch embeddings at the tokens' scale
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        5, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEV)
    pos = vl_positions(torch, B, Nv, S, DEV)
    cache = model.init_cache(B, Nv + S + VL_DECODE, DEV)

    def run():
        with torch.no_grad():
            first = model.prefill(params, toks, pos, cache,
                                  vision_embeds=vis)
            out = [first.argmax(-1)]
            for _ in range(VL_DECODE - 1):
                out.append(model.decode_step(
                    params, out[-1][:, None].to(torch.int32),
                    cache).argmax(-1))
            return first.float(), torch.stack(out, 1)

    shapes = FlashShapes(ops, heads=cfg.num_heads)
    shapes.install()
    try:
        t0 = time.perf_counter()
        (first, out), launches = _count_launches(ops, run)
        wall = time.perf_counter() - t0
    finally:
        shapes.remove()
    check(cache.length == Nv + S + VL_DECODE - 1,
          f"qwen2-vl vision: cache length {cache.length}")
    check(bool(torch.isfinite(first).all()), "qwen2-vl vision: non-finite")
    check(launches["flash_attention"] > 0
          and shapes.best["prefill"][1][0].shape[1] == Nv + S,
          f"qwen2-vl vision: launches {launches}")
    full = torch.cat([toks, out[:, :-1].to(torch.int32)], 1)
    with torch.no_grad():
        feats = model.forward(params, full, vl_positions(
            torch, B, Nv, full.shape[1], DEV), return_features=True,
            vision_embeds=vis)
        lg = model.head(params, feats[:, Nv + S - 1:]).float()
        flat = model.forward(params, toks, pos[0], return_features=True,
                             vision_embeds=vis)
        lg_flat = model.head(params, flat[:, -1]).float()
    err = max_err(first, lg[:, 0])
    moved = max_err(lg_flat, lg[:, 0])
    check(err <= NEAR_TIE, f"qwen2-vl vision: prefill logits {err} from "
          "the forward's")
    check(moved > NEAR_TIE, f"qwen2-vl vision: the h/w positions moved "
          f"the logits by {moved} only")
    pred = lg.argmax(-1)
    parted = []
    for b, t in zip(*torch.nonzero(pred != out, as_tuple=True)):
        row = lg[b, t]
        below = (float(row.max() - row[pred[b, t]]),
                 float(row.max() - row[out[b, t]]))
        parted.append((int(b), int(t), round(below[1], 4)))
        check(max(below) <= NEAR_TIE, f"qwen2-vl vision: row {int(b)} token "
              f"{int(t)} is {below[1]:.4f} below the forward's top logit")
    log(f"qwen[vision]: qwen2-vl-72b ({cfg.num_layers} of 80 layers) "
        f"prefill of {B} rows x ({Nv} patches + {S} tokens) at t/h/w "
        f"positions, {VL_DECODE - 1} decode steps in {wall:.3f} s: prefill "
        f"logits {err:.4f} from the forward's (max |diff|), the forward "
        f"at t positions only {moved:.4f} from them; {len(parted)} of "
        f"{out.numel()} greedy tokens part from the teacher-forced "
        f"forward's argmax, each a near-tie (row, token, distance below "
        f"the top logit): {parted}; launches {json.dumps(launches)} {tag}")
    return shapes, launches


def qwen_parity(torch) -> None:
    """(c): both smoke configs and qwen3's at 128 experts top-8 (f32) on
    the card and on the CPU from the same weights: every serving path's
    greedy tokens (``smoke_parity``); then qwen2-vl's forward over an
    8-patch prefix at t/h/w positions, and its prefill + 3 decode
    steps, within 1e-4 of the CPU's logits."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    rng = np.random.default_rng(0)
    vl = get_smoke_config(QWEN_VL)
    for label, cfg in ((QWEN3, get_smoke_config(QWEN3)),
                       (f"{QWEN3} top-8 of 128", _k8(get_smoke_config(QWEN3))),
                       (QWEN_VL, vl)):
        smoke_parity(torch, cfg, label, "qwen", rng)
    params_cpu = Model(vl).init_params(seed=0, device="cpu")
    B, Nv, S = 2, vl.num_vision_tokens, 12
    gen = torch.Generator().manual_seed(4)
    vis = torch.randn(B, Nv, vl.d_model, generator=gen)
    toks = torch.as_tensor(rng.integers(5, vl.vocab_size, (B, S)),
                           dtype=torch.int32)
    steps = torch.as_tensor(rng.integers(5, vl.vocab_size, (3, B, 1)),
                            dtype=torch.int32)

    def logits(params, dev):
        model = Model(vl)
        pos = vl_positions(torch, B, Nv, S, dev)
        out = [model.forward(params, toks.to(dev), pos,
                             vision_embeds=vis.to(dev))]
        cache = model.init_cache(B, Nv + S + 3, dev)
        out.append(model.prefill(params, toks.to(dev), pos, cache,
                                 vision_embeds=vis.to(dev)))
        out += [model.decode_step(params, t.to(dev), cache) for t in steps]
        return [o.cpu() for o in out]

    got = logits(_to_device(params_cpu, DEV), DEV)
    want = logits(params_cpu, "cpu")
    err = max(max_err(g, w) for g, w in zip(got, want))
    check(err <= 1e-4, f"qwen parity: qwen2-vl vision logits {err} apart")
    log(f"qwen parity: qwen2-vl smoke forward over {Nv} patches + {S} "
        f"tokens at t/h/w positions, prefill + 3 decode steps: card and "
        f"CPU logits within {err:.2e} (tol 1e-4)")


def qwen_kernels(torch, ops, q3, vl, vision_shapes, rec, card) -> None:
    """(d): the paged decode kernel at G 8 exactly (qwen3 q [4,32,128] over
    4 KV heads, qwen2-vl [4,64,128] over 8, from each arch's queue) and
    the flash kernel's Sq > 16 route at G 8, hd 128 (qwen3's paged chunk,
    qwen2-vl's vision-prefix prefill), each against its plain version,
    timed beside it and SDPA; the rows join the kernels line's
    "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    paged_rows, flash_rows = [], []
    for arch, (launches, r, shapes), want in ((QWEN3, q3, [4, 32, 128]),
                                              (QWEN_VL, vl, [4, 64, 128])):
        check("paged_decode_attention" in r.best,
              f"{arch}: the queue's paged decode inputs were not recorded")
        _, args, kw = r.best["paged_decode_attention"]
        check(list(args[0].shape) == want and want[1] // args[1].shape[2]
              == 8, f"{arch} paged decode recorded at "
              f"q{list(args[0].shape)} pool{list(args[1].shape)}")
        paged_rows.append(_paged_row(
            torch, F, ops, ref, args, kw, f"{arch} paged decode (G 8)",
            launches["paged_decode_attention"], card))
        if arch == QWEN3:
            check("chunk" in shapes.best, "no qwen3 chunk was recorded")
            _, args, kw = shapes.best["chunk"]
            check(args[0].shape[1] == DENSE_QUEUE["prefill_chunk"]
                  and args[0].shape[2] // args[1].shape[2] == 8,
                  f"qwen3 chunk recorded at q{list(args[0].shape)}")
            flash_rows.append(_flash_row(
                torch, F, ops, ref, args, kw, "qwen3 paged chunk of 32 (G 8)",
                shapes.calls["chunk"], card))
    _, args, kw = vision_shapes.best["prefill"]
    flash_rows.append(_flash_row(
        torch, F, ops, ref, args, kw,
        "qwen2-vl prefill, 256 patches + 40 tokens (G 8)",
        vision_shapes.calls["prefill"], card))
    rec.setdefault("paged_decode_attention", {}).setdefault(
        "shapes", []).extend(paged_rows)
    rec.setdefault("flash_attention", {}).setdefault("shapes", []).extend(
        flash_rows)


def phase_qwen(torch, card, rec: dict) -> dict:
    """qwen3-moe-30b-a3b (qk-norm, 128 experts top-8) and qwen2-vl-72b
    (M-RoPE, the stub vision prefix) on the card, one model at a time,
    each freed before the next: (a) serve.py at qwen3's published width
    and qwen2-vl --smoke; qwen3's paged queue against solo runs and its
    MoE layer's time; (b) qwen2-vl at a reduced depth: the vision prefill
    and decode, then the paged queue against solo runs; (c) card-vs-CPU
    parity at the smoke configs; (d) the kernels at the archs' shapes.
    Returns the launches of (a)-(c)'s paths together."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    tag = f"[{card['smi']}]"
    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    torch.cuda.reset_peak_memory_stats()
    add(_serve_cli(torch, ops, serve, QWEN3, tag))
    log(f"qwen: serve.py --arch {QWEN3} peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    free_models(torch)
    add(_serve_smoke(torch, ops, serve, QWEN_VL, tag))
    free_models(torch)
    cfg = get_config(QWEN3)
    params = _draw(torch, cfg, QWEN3)
    q3 = dense_queue(torch, ops, cfg, params, tag)
    add(q3[0])
    gen = torch.Generator(device=DEV)
    gen.manual_seed(12)
    moe_layer_times(torch, gen, cfg, params["blocks"][0]["moe"],
                    ((2, 1, "decode (2 rows)"), (4, 1, "decode (4 rows)"),
                     (1, 32, "chunk of 32")), QWEN3, card)
    log(f"qwen: {QWEN3} peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB over its queue and MoE timing")
    del params
    free_models(torch)
    depth = vl_depth(torch, get_config(QWEN_VL))
    vl_cfg = dataclasses.replace(get_config(QWEN_VL), num_layers=depth)
    log(f"qwen: {QWEN_VL} reduced to {depth} of 80 layers (bf16 weights "
        f"~{vl_cfg.param_count() * 2 / 1e9:.1f} GB on a "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f} "
        f"GiB card, {VL_RESERVE_BYTES / 2 ** 30:.0f} GiB reserved)")
    params = _draw(torch, vl_cfg, f"{QWEN_VL} at {depth} layers")
    vision_shapes, launches = qwen_vision(torch, ops, vl_cfg, params, tag)
    add(launches)
    vl = dense_queue(torch, ops, vl_cfg, params, tag)
    add(vl[0])
    log(f"qwen: {QWEN_VL} at {depth} layers peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del params
    free_models(torch)
    qwen_parity(torch)
    qwen_kernels(torch, ops, q3, vl, vision_shapes, rec, card)
    del q3, vl, vision_shapes
    free_models(torch)
    log(f"qwen: launches on the paths {json.dumps(total)}")
    return total


# whisper-base (ROADMAP A4): the encoder-decoder, served text-only on the
# stub frontend's zero frames, as the reference serves it
WHISPER = "whisper-base"
# (b), (c): learned positions make a left-padded solo wave read its table
# at absolute positions and a queue row at positions counted from its
# first token, so the requests that are held to solo runs have
# power-of-two lengths (no bucket pad): a 240-token context (left-padded
# by 16 to the chunk of 32) forked into four 16-token questions, and
# plain prompts of 64, 128 and 32 tokens
WHISPER_CTX, WHISPER_Q, WHISPER_PLAIN = 240, 16, (64, 128, 32)
WHISPER_KINDS = ("encoder", "cross chunk", "cross decode")
# (b): the wave's and the paged path's bf16 logits against the forward's
# (the same kernels in another order through 6 + 6 layers): about three
# times the 0.0156 (one bf16 ulp at the logits' size, ~2) first measured
# on an H100, a ninth of the logits' spread (std 0.45)
WHISPER_LOGIT_TOL = 0.05


def _whisper_stream(vocab):
    """(b)'s requests: (prompt, budget, prefix_len), budgets 6 to 16."""
    import numpy as np
    rng = np.random.default_rng(7)
    ctx = rng.integers(5, vocab, WHISPER_CTX).tolist()
    q = [rng.integers(5, vocab, WHISPER_Q).tolist() for _ in range(4)]
    plain = [rng.integers(5, vocab, n).tolist() for n in WHISPER_PLAIN]
    pl = WHISPER_CTX
    return [(ctx + q[0], 16, pl), (plain[0], 6, 0), (plain[1], 12, 0),
            (plain[2], 8, 0), (ctx + q[1], 16, pl), (ctx + q[2], 10, pl),
            (ctx + q[3], 14, pl)]


def _whisper_kind(cfg):
    """The call kinds of whisper's own flash shapes: the encoder
    (non-causal, Sq = Sk = Se), cross-attention over Se keys at more
    queries (non-causal flash) or at one (the decode read); None for
    self-attention (no buffer of these runs has Se slots)."""
    Se = cfg.encoder_seq_len

    def kind(q, k, causal):
        Sq, Sk = q.shape[1], k.shape[1]
        if Sk != Se:
            return None
        if Sq == Se and not causal:
            return "encoder"
        return "cross decode" if Sq == 1 else "cross chunk"
    return kind


def whisper_logits(torch, ops, cfg, params, tag) -> dict:
    """(b): the logits behind the queue's tokens at published width, where
    random weights make each greedy stream repeat one token: two rows of
    256 tokens (no pads) through the full forward, a wave prefill with
    decode steps at absolute positions, and paged chunks of 32 with
    decode steps, each decode step fed the forward's next input token.
    The prefill, the last chunk and every decode step must agree with
    the teacher-forced forward within ``WHISPER_LOGIT_TOL``, with the
    same argmax where the forward's top two logits are further apart
    than that.  Returns the launches."""
    import numpy as np
    from repro_torch.models import Model
    model = Model(cfg)
    B, S, n, C = 2, 256, 8, DENSE_QUEUE["prefill_chunk"]
    bs = DENSE_QUEUE["block_size"]
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        5, cfg.vocab_size, (B, S + n)), dtype=torch.int32, device=DEV)
    pos = torch.arange(S + n, dtype=torch.int32, device=DEV)[None] \
        .expand(B, S + n).contiguous()
    frames = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model), device=DEV)
    nb = -(-(S + n) // bs)

    def run():
        with torch.no_grad():
            fwd = model.forward(params, toks, pos, encoder_frames=frames)
            fwd = fwd[:, S - 1:S + n - 1].float()
            c = model.init_cache(B, S + n, DEV)
            wave = [model.prefill(params, toks[:, :S], pos[:, :S], c,
                                  encoder_frames=frames)]
            wave += [model.decode_step(params, toks[:, t:t + 1], c)
                     for t in range(S, S + n - 1)]
            pc = model.init_paged_cache(B, S + n, bs, B * nb, DEV)
            pc.block_tables = torch.arange(B * nb, dtype=torch.int32,
                                           device=DEV).reshape(B, nb)
            for j in range(S // C):
                chunk = model.prefill_chunk(
                    params, toks[:, j * C:(j + 1) * C],
                    pos[:, j * C:(j + 1) * C], pc, encoder_frames=frames)
            paged = [chunk] + [model.decode_step(params, toks[:, t:t + 1],
                                                 pc, nb_cap=nb)
                               for t in range(S, S + n - 1)]
            return fwd, torch.stack(wave, 1).float(), \
                torch.stack(paged, 1).float()

    (fwd, wave, paged), launches = _count_launches(ops, run)
    top2 = fwd.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    errs = {}
    for name, got in (("wave", wave), ("paged", paged)):
        errs[name] = max_err(got, fwd)
        check(errs[name] <= WHISPER_LOGIT_TOL, f"whisper logits: the {name} "
              f"path is {errs[name]:.4f} from the forward's")
        clear = gap > WHISPER_LOGIT_TOL
        check(bool((got.argmax(-1) == fwd.argmax(-1))[clear].all()),
              f"whisper logits: the {name} path's argmax differs where the "
              "forward's top two are apart")
    check(launches["paged_decode_attention"] > 0
          and launches["flash_attention"] > 0,
          f"whisper logits: launches {launches}")
    distinct = len(set(fwd.argmax(-1).flatten().tolist()))
    log(f"whisper[logits]: {B} rows x {S} tokens + {n - 1} decode steps, "
        f"the forward's logits at the {n} positions against the wave "
        f"prefill + decode ({errs['wave']:.4f} max |diff|) and paged "
        f"chunks of {C} + decode ({errs['paged']:.4f}; tol "
        f"{WHISPER_LOGIT_TOL}); the forward's top-2 "
        f"gap {float(gap.min()):.4f} to {float(gap.max()):.4f}, logits "
        f"spread (std) {float(fwd.std()):.4f}, {distinct} distinct argmax "
        f"tokens of {fwd.shape[0] * fwd.shape[1]}; launches "
        f"{json.dumps(launches)} {tag}")
    return launches


def whisper_standing(torch, ops, cfg, params, tag) -> dict:
    """(c): the paged standing queue (one session for every round) over
    (b)'s requests in three rounds: the first waits for both its
    requests, the second only for its short one (the long one straddles
    into the third round), the third for everything.  Each request is
    held to a solo ``generate_reference`` run (``_hold_to_solo``).
    Returns the path's launches."""
    from repro_torch.serving import (ContinuousQueue, GenerationParams,
                                     ServeEngine)
    stream = _whisper_stream(cfg.vocab_size)
    # (stream index, budget): request 2 (128 tokens, 16 new) straddles
    rounds = [([(0, 16), (1, 6)], "all"), ([(2, 16), (3, 4)], "last"),
              ([(4, 16), (5, 10), (6, 14)], "all")]
    eng = ServeEngine(cfg, params, device=DEV, **DENSE_QUEUE)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=DENSE_NEW),
                        standing=True)
    runs, straddled = [], []

    def run():
        for reqs, wait in rounds:
            rids = [q.submit(stream[i][0], b, prefix_len=stream[i][2])
                    for i, b in reqs]
            runs.extend((r, i, b) for r, (i, b) in zip(rids, reqs))
            q.run(wait_for=rids if wait == "all" else rids[-1:])
            straddled.extend(q.unfinished())
        q.close()

    t0 = time.perf_counter()
    _, launches = _count_launches(ops, run)
    wall = time.perf_counter() - t0
    st = q.stats
    check(st.frames == 1 and st.refills >= 3 and st.prefix_hits >= 1,
          f"whisper standing: frames {st.frames}, refills {st.refills}, "
          f"prefix hits {st.prefix_hits}")
    check(launches["paged_decode_attention"] > 0
          and launches["flash_attention"] > 0,
          f"whisper standing: launches {launches}")
    equal, parted = _hold_to_solo(torch, cfg, params, [
        (r, q.result(r).tokens, stream[i][0], b) for r, i, b in runs],
        "whisper standing")
    log(f"whisper[standing]: the paged standing queue, {len(runs)} requests "
        f"in {len(rounds)} rounds in {wall:.3f} s: {st.frames} frame, "
        f"{st.refills} refills, {st.prefix_hits} prefix hits, requests "
        f"straddling a round {sorted(set(straddled))}; {equal} of "
        f"{len(runs)} equal their solo generate_reference tokens, parted "
        f"(request, token, the solo and the queue token's distance below "
        f"the forward's top logit): {parted}; launches "
        f"{json.dumps(launches)} {tag}")
    return launches


def whisper_split(torch, cfg, params, tag) -> None:
    """(f): (b)'s queue again on a fresh engine, synchronised around
    every prefill chunk, every encoder pass inside it and every decode
    step: the encoder's share of a paged chunk (it runs again on every
    chunk, as in the reference)."""
    from repro_torch.serving import (ContinuousQueue, GenerationParams,
                                     ServeEngine)
    eng = ServeEngine(cfg, params, device=DEV, **DENSE_QUEUE)
    acc = {"chunk": [], "encoder": [], "decode": []}

    def timed(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[name].append(time.perf_counter() - t0)
            return out
        return wrapped

    model = eng.model
    model.encode = timed("encoder", model.encode)
    model.decode_step = timed("decode", model.decode_step)
    eng._chunk_step = timed("chunk", eng._chunk_step)
    q = ContinuousQueue(eng, GenerationParams(max_new_tokens=DENSE_NEW))
    for p, b, pl in _whisper_stream(cfg.vocab_size):
        q.submit(p, b, prefix_len=pl)
    q.run()
    n = len(acc["chunk"])
    check(n > 0 and len(acc["encoder"]) == n,
          f"whisper split: {n} chunks, {len(acc['encoder'])} encoder passes")
    chunk_s, enc_s = sum(acc["chunk"]), sum(acc["encoder"])
    dec = acc["decode"]
    log(f"whisper[split]: {n} paged chunks of {DENSE_QUEUE['prefill_chunk']}"
        f" (frame of {DENSE_QUEUE['batch_size']} rows and one-row refills, "
        f"synchronised): {chunk_s * 1e3:.3f} ms in chunks, "
        f"{enc_s * 1e3:.3f} ms of it in the encoder over "
        f"{cfg.encoder_seq_len} frames ({100 * enc_s / chunk_s:.2f}%; "
        f"{enc_s / n * 1e3:.3f} ms a pass, {chunk_s / n * 1e3:.3f} ms a "
        f"chunk); {len(dec)} decode steps, median "
        f"{statistics.median(dec) * 1e3:.3f} ms {tag}")


def whisper_parity(torch) -> None:
    """(d): the smoke config (f32) on the card and on the CPU from the
    same weights: every serving path's greedy tokens (``smoke_parity``);
    then the encoder alone, the forward over seeded frames with a
    left-padded row, a prefill + 3 decode steps and two paged chunks +
    3 decode steps (a right-padded row) within 1e-4 of the CPU's."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models import cache as cache_lib
    rng = np.random.default_rng(0)
    cfg = get_smoke_config(WHISPER)
    smoke_parity(torch, cfg, WHISPER, "whisper", rng)
    params_cpu = Model(cfg).init_params(seed=0, device="cpu", max_seq=64)
    B, S, C = 2, 16, 8
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn(B, cfg.encoder_seq_len, cfg.d_model, generator=gen)
    toks = torch.as_tensor(rng.integers(5, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    pos[1, :5] = -1                               # row 1 left-padded
    steps = torch.as_tensor(rng.integers(5, cfg.vocab_size, (3, B, 1)),
                            dtype=torch.int32)
    first = torch.tensor([0, 5], dtype=torch.int32)
    l_end = torch.tensor([S, 11], dtype=torch.int32)   # row 1 right-padded

    def logits(params, dev):
        model = Model(cfg)
        f = frames.to(dev)
        out = [model.encode(params, f),
               model.forward(params, toks.to(dev), pos.to(dev),
                             encoder_frames=f)]
        cache = model.init_cache(B, S + 3, dev)
        cache.first = first.to(dev)
        out.append(model.prefill(params, toks.to(dev), pos.to(dev), cache,
                                 encoder_frames=f))
        out += [model.decode_step(params, t.to(dev), cache) for t in steps]
        pc = model.init_paged_cache(B, 32, 8, 8, dev)
        pc.block_tables = torch.tensor([[3, 1, 6, 0], [2, 7, 5, 4]],
                                       dtype=torch.int32, device=dev)
        for j in range(S // C):
            cols = torch.arange(j * C, (j + 1) * C, dtype=torch.int32)[None]
            cp = torch.where(cols < l_end[:, None], cols, -1)
            last = (l_end - 1 - j * C).clamp(0, C - 1)
            out.append(model.prefill_chunk(
                params, toks[:, j * C:(j + 1) * C].to(dev), cp.to(dev), pc,
                last_col=last.to(dev), encoder_frames=f))
        pc.length = l_end.to(dev)
        out += [model.decode_step(params, t.to(dev), pc, nb_cap=4)
                for t in steps]
        out += [pc.state[i][n] for i in range(cfg.num_layers)
                for n in ("xk", "xv")]
        return [o.cpu() for o in out]

    check(cache_lib.init_row_state(cfg, 1, 8, torch.float32, "cpu")[0]
          ["xk"].shape[1] == cfg.encoder_seq_len, "whisper: no cross K/V")
    got = logits(_to_device(params_cpu, DEV), DEV)
    want = logits(params_cpu, "cpu")
    err = max(max_err(g, w) for g, w in zip(got, want))
    check(err <= 1e-4, f"whisper parity: card and CPU {err} apart")
    log(f"whisper parity: smoke ({cfg.num_encoder_layers}+"
        f"{cfg.num_layers} layers d{cfg.d_model}, {cfg.encoder_seq_len} "
        f"frames, f32) encoder, forward, prefill + 3 decode steps, 2 paged "
        f"chunks + 3 decode steps and the stored cross-attention K/V: card "
        f"and CPU within {err:.2e} (tol 1e-4)")


def whisper_kernels(torch, ops, cfg, queue, rec, card) -> None:
    """(e): the flash kernel at whisper's three new shapes from (b)'s
    queue (the encoder over Se frames, a cross-attention chunk of 32
    queries and the cross-attention decode of 4 rows, each over Se keys
    at position 0) and the paged decode kernel at G 1, hd 64 (the
    queue's self-attention decode), each against its plain version,
    timed beside it and SDPA; the rows join the kernels line's
    "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    launches, r, shapes = queue
    B, C = DENSE_QUEUE["batch_size"], DENSE_QUEUE["prefill_chunk"]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    kv = [B, cfg.encoder_seq_len, cfg.num_kv_heads, hd]
    rows = []
    for kind, label in (("encoder", "whisper encoder (non-causal)"),
                        ("cross chunk", "whisper cross-attention chunk"),
                        ("cross decode", "whisper cross-attention decode")):
        check(kind in shapes.best, f"whisper: no {kind} flash call recorded")
        _, args, kw = shapes.best[kind]
        q, k = args[0], args[1]
        want_q = [B, {"encoder": cfg.encoder_seq_len, "cross chunk": C,
                      "cross decode": 1}[kind], H, hd]
        check(list(q.shape) == want_q and list(k.shape) == kv,
              f"whisper {kind} recorded at q{list(q.shape)} k{list(k.shape)}")
        rows.append(_flash_row(torch, F, ops, ref, args, kw, label,
                               shapes.calls[kind], card))
    rec.setdefault("flash_attention", {}).setdefault("shapes", []).extend(
        rows)
    check("paged_decode_attention" in r.best,
          "whisper: the queue's paged decode inputs were not recorded")
    _, args, kw = r.best["paged_decode_attention"]
    check(list(args[0].shape) == [B, H, hd]
          and args[1].shape[2] == cfg.num_kv_heads,
          f"whisper paged decode recorded at q{list(args[0].shape)} "
          f"pool{list(args[1].shape)}")
    rec.setdefault("paged_decode_attention", {}).setdefault(
        "shapes", []).append(_paged_row(
            torch, F, ops, ref, args, kw, "whisper paged decode (G 1, hd 64)",
            launches["paged_decode_attention"], card))


def phase_whisper(torch, card, rec: dict) -> dict:
    """whisper-base on the card at published width (bf16, seed 0; 6+6
    layers, d 512, 1500 frames): (a) serve.py --arch whisper-base; (b)
    the paged queue with the prefix cache against solo runs, and the
    logits of the wave and the paged path against the forward's; (c) the
    paged standing queue against solo runs; (d) card-vs-CPU parity at
    the smoke config; (e) the kernels at whisper's shapes; (f) the
    encoder's share of a paged chunk.  Returns the launches of (a)-(c)'s
    paths together."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    tag = f"[{card['smi']}]"
    total = {}

    def add(launches):
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

    torch.cuda.reset_peak_memory_stats()
    add(_serve_cli(torch, ops, serve, WHISPER, tag))
    log(f"whisper: serve.py --arch {WHISPER} peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    free_models(torch)
    cfg = get_config(WHISPER)
    torch.cuda.reset_peak_memory_stats()
    params = _draw(torch, cfg, WHISPER, "whisper")
    shapes = FlashShapes(ops, kinds=WHISPER_KINDS, kind_of=_whisper_kind(cfg))
    queue = dense_queue(torch, ops, cfg, params, tag,
                        stream=_whisper_stream(cfg.vocab_size), shapes=shapes)
    add(queue[0])
    add(whisper_logits(torch, ops, cfg, params, tag))
    add(whisper_standing(torch, ops, cfg, params, tag))
    whisper_split(torch, cfg, params, tag)
    log(f"whisper: {WHISPER} peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB over its queues")
    del params
    free_models(torch)
    whisper_parity(torch)
    whisper_kernels(torch, ops, cfg, queue, rec, card)
    del queue, shapes
    free_models(torch)
    log(f"whisper: launches on the paths {json.dumps(total)}")
    return total


# ------------------------------------------------------------------ train

TRAIN_ARCH = "olmo-1b"      # launch/train.py's default arch, train_tiny's
# (a): the backward kernel's cases: (label, B, S, H, KV, hd, dtype,
# causal, window, softcap, invalid kv slots)
TRAIN_BWD_CASES = (
    ("olmo-1b training", 4, 256, 16, 16, 128, "bfloat16", True, None, None,
     False),
    ("hd 256 G 2 window 64 softcap 50", 2, 128, 16, 8, 256, "bfloat16",
     True, 64, 50.0, False),
    ("f32 invalid kv slots G 2", 2, 80, 4, 2, 64, "float32", True, None,
     None, True),
    # whisper-base's encoder at published width (1500 frames, 8 heads of
    # 64, not causal): no tile skip, hd 64, a tail of 1500 mod 64 rows
    ("whisper-base encoder", 4, 1500, 8, 8, 64, "bfloat16", False, None,
     None, False),
)
# bf16: the kernel's f32 gradients rounded to bf16, against the plain
# backward in f32 on the same bf16 inputs, also apart by the forward's
# bf16 P inside O (delta = rowsum(dO * O)); f32: the same f32 math in
# another order
BWD_TOL_BF16 = 2e-2       # of the largest |gradient|
BWD_TOL_F32 = 1e-4
# (b): the launcher at published width, bf16, remat on
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--steps", "6", "--batch", "4", "--seq",
             "256"]
TRAIN_FIXED_STEPS = 8     # (c)
TRAIN_PARITY_ARCHS = ("olmo-1b", "gemma2-9b", "qwen2-moe-a2.7b")   # (d)
TRAIN_PARITY_LR = 1e-3
TINY_CLI = ["--smoke", "--nodes", "2", "--slots", "2"]    # (e)


def bwd_work(q, k, q_pos, kv_pos, causal=True, window=None):
    """Bytes and flops of one backward call: q, O, dO read and dq
    written, k, v read and dk, dv written, the row lse read; 10*hd flops
    per head per valid (query, key) pair (S and dP recomputed, dV, dK and
    dQ accumulated: five products)."""
    _, fwd_flops = flash_work(q, k, q_pos, kv_pos, causal, window)
    B, Sq, H, _ = q.shape
    nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
              + 4 * B * H * Sq + 4 * (q_pos.numel() + kv_pos.numel()))
    return nbytes, fwd_flops * 10 // 4


def _bwd_case(torch, gen, B, S, H, KV, hd, dtype, invalid):
    """q, k, v, dO [B,S,...] on the card in ``dtype`` and positions: q = k
    aligned; with ``invalid`` row 0 left-padded by 7 (pad queries at -1)
    and every 5th key slot of row 1 invalid (-1).  dO is 0 on a query row
    that sees no valid key (unspecified rows compare nothing)."""
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device=DEV).to(dt)
    q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
    do = r(B, S, H, hd)
    pos = torch.arange(S, dtype=torch.int32, device=DEV).repeat(B, 1)
    qp, kvp = pos.clone(), pos.clone()
    if invalid:
        qp[0] -= 7
        kvp[0] -= 7
        kvp[1, ::5] = -1
        qp[qp < 0] = -1
        kvp[kvp < 0] = -1
    return q, k, v, do, qp.contiguous(), kvp.contiguous()


def _live(torch, qp, kvp, causal, window):
    kp, qq = kvp[:, None, :], qp[:, :, None]
    ok = (kp >= 0).expand(-1, qp.shape[1], -1)
    if causal:
        ok = ok & (kp <= qq)
    if window:
        ok = ok & (qq - kp < window)
    return ok.any(-1)                                         # [B, S]


def _sdpa_bwd(torch, F, q, k, v, do, qp, kvp, causal, window):
    """Yardstick: SDPA's backward on the same function (None with a
    softcap, which SDPA has no form for): is_causal for aligned causal
    inputs, no mask where every pair counts (not causal, no window, no
    invalid key), else the position mask as a bool mask, GQA by
    repeating the KV heads.  Times the backward of one forward kept
    alive."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for x in (k, v))
    aligned = causal and not window and bool((qp == kvp).all()) \
        and bool((kvp >= 0).all())
    every = not causal and not window and bool((kvp >= 0).all())
    if aligned:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    elif every:
        o = F.scaled_dot_product_attention(qt, kt, vt)
    else:
        kp, qq = kvp[:, None, :], qp[:, :, None]
        mask = kp >= 0
        if causal:
            mask = mask & (kp <= qq)
        if window:
            mask = mask & (qq - kp < window)
        mask = mask | ~mask.any(-1, keepdim=True)   # no all-masked row
        o = F.scaled_dot_product_attention(qt, kt, vt,
                                           attn_mask=mask[:, None])
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                       retain_graph=True)


def train_kernels(torch, F, ops, ref, rec, card) -> None:
    """(a): flash_attention_bwd.cu against autograd of the plain version
    at the shapes of TRAIN_BWD_CASES, timed beside it and SDPA's
    backward."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(30)
    rows = []
    for (label, B, S, H, KV, hd, dtype, causal, window, cap,
         invalid) in TRAIN_BWD_CASES:
        q, k, v, do, qp, kvp = _bwd_case(torch, gen, B, S, H, KV, hd, dtype,
                                         invalid)
        kw = {"causal": causal, "window": window, "softcap": cap}
        live = _live(torch, qp, kvp, causal, window)
        do = do * live[:, :, None, None].to(do.dtype)
        lse = torch.empty((B, H, S), dtype=torch.float32, device=DEV)
        out = ops._flash_launch(q, k, v, qp, kvp, causal, window, cap,
                                lse=lse)
        got = ops.flash_attention_bwd(q, k, v, qp, kvp, out, do, lse, **kw)
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                           qp, kvp, do.float(), **kw)
        torch.cuda.synchronize()
        errs = []
        for name, g, w, m in zip(("dq", "dk", "dv"), got, want,
                                 (live, None, None)):
            check(g.dtype == q.dtype and bool(torch.isfinite(g).all()),
                  f"bwd {label}: {name} non-finite or of dtype {g.dtype}")
            g, w = g.float(), w.float()
            if m is not None:
                g, w = g[m], w[m]
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            tol = BWD_TOL_F32 if dtype == "float32" \
                else BWD_TOL_BF16 * scale
            check(err <= tol, f"bwd {label}: {name} max|err| {err:.3e} > "
                  f"{tol:.3e} (max|grad| {scale:.3e})")
            errs.append((name, err, tol, scale))
        again = ops.flash_attention_bwd(q, k, v, qp, kvp, out, do, lse, **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"bwd {label}: two calls differ (the kernel has no atomics)")
        t_k = bench_ms(lambda: ops.flash_attention_bwd(q, k, v, qp, kvp, out,
                                                       do, lse, **kw))
        t_p = bench_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, qp, kvp,
                                                           do, **kw))
        t_l = None if cap else bench_ms(_sdpa_bwd(torch, F, q, k, v, do, qp,
                                                  kvp, causal, window))
        nbytes, flops = bwd_work(q, k, qp, kvp, causal, window)
        bnd, by = bound_ms(nbytes, flops, dtype)
        err = max(e for _, e, _, _ in errs)
        log(f"  flash_attention_bwd [{label}] q{tuple(q.shape)} "
            f"k{tuple(k.shape)} {dtype}: "
            + ", ".join(f"{n} max|err| {e:.3e} (tol {t:.3e}, max|grad| "
                        f"{s:.3e})" for n, e, t, s in errs)
            + f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, SDPA backward "
            + ("n/a (softcap)" if t_l is None else f"{t_l:.4f} ms")
            + f", bound {bnd:.5f} ms ({by}, {nbytes} bytes, {flops} flops) "
            f"[{card['smi']}]")
        rows.append({"shape": label, "q": list(q.shape), "k": list(k.shape),
                     "dtype": dtype, "max_abs_err": err, "ms": t_k,
                     "plain_ms": t_p, "bound_ms": bnd, "bound_by": by,
                     "library_ms": t_l})
        del q, k, v, do, out, lse, got, want, again
    main = rows[0]
    rec["flash_attention_bwd"] = {key: main[key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")}
    rec["flash_attention_bwd"]["shapes"] = rows


def train_launcher(torch, ops, ref, tag, bwd_ms) -> dict:
    """(b): launch/train.py at olmo-1b's published width through its
    main; its launches, and the plain versions' calls (none).  The
    backward's ms a step is its launches a step times ``bwd_ms``, (a)'s
    kernel time at this shape."""
    import numpy as np
    from repro_torch.launch import train
    from repro_torch.train import checkpoint
    path = ROOT / "build" / "train_ckpt" / "olmo_1b.npz"
    plain = {"calls": 0}

    def counted(fn):
        def wrapped(*a, **kw):
            plain["calls"] += 1
            return fn(*a, **kw)
        return wrapped

    orig = (ref.flash_attention_ref, ref.flash_attention_bwd_ref)
    ref.flash_attention_ref, ref.flash_attention_bwd_ref = map(counted, orig)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out, launches = _count_launches(
            ops, lambda: train.main(TRAIN_CLI + ["--ckpt", str(path)]))
    finally:
        ref.flash_attention_ref, ref.flash_attention_bwd_ref = orig
    wall = time.perf_counter() - t0
    cfg, steps = out["cfg"], int(TRAIN_CLI[TRAIN_CLI.index("--steps") + 1])
    n_attn = sum(kind == "attn" for kind in
                 (cfg.pattern_for_layer(i) for i in range(cfg.num_layers)))
    want = {"flash_attention": 2 * n_attn * steps,      # forward + recompute
            "flash_attention_bwd": n_attn * steps}
    check(all(np.isfinite(out["losses"])), f"train: losses {out['losses']}")
    check(plain["calls"] == 0, f"train: {plain['calls']} plain attention "
          "calls on the card path")
    check({k: c for k, c in launches.items() if c} == want,
          f"train: launches {launches}, want {want}")
    params = sum(t.numel() for t in tree_leaves(out["params"]))
    t1 = time.perf_counter()
    back = checkpoint.load(str(path), out["params"], cfg)
    load_s = time.perf_counter() - t1
    check(all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(out["params"]))),
        "train: the checkpoint does not load back into equal params")
    size = path.stat().st_size
    path.unlink()
    per_step = launches["flash_attention_bwd"] // steps
    log(f"train[b]: launch/train.py {' '.join(TRAIN_CLI)} --ckpt: "
        f"{params / 1e9:.3f}B params ({cfg.dtype}, remat on), losses "
        f"{[round(x, 4) for x in out['losses']]}; step {out['step_ms']:.1f} "
        f"ms (median of steps 1-{steps - 1}), of it the backward kernel "
        f"{per_step} x {bwd_ms:.4f} = {per_step * bwd_ms:.2f} ms (launches "
        f"a step x (a)'s kernel ms), {out['tokens_per_s']:.0f} "
        f"tokens/s, peak {out['peak_gib'] or 0:.2f} GiB; {wall:.1f} s with the "
        f"checkpoint ({size / 2 ** 30:.2f} GiB written, loaded back equal "
        f"in {load_s:.1f} s); launches {json.dumps(launches)} (plain "
        f"attention calls 0) {tag}")
    del out, back
    free_models(torch)
    return launches


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, in order."""
    from repro_torch.train import optimizer
    return optimizer.tree_leaves(tree)


def train_fixed_batch(torch, tag) -> None:
    """(c): the published-width model from seed 0, one fixed batch (4 x
    256, seed 1234), 8 steps at lr 1e-3 with remat: the loss falls."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train.train_step import init_opt_state, make_train_step
    cfg = get_config(TRAIN_ARCH)
    model = Model(cfg)
    params = model.init_params(seed=0, device=DEV, max_seq=256)
    opt = init_opt_state(params)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1234)
    toks = torch.randint(0, cfg.vocab_size, (4, 257), generator=gen,
                         device=DEV)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "positions": torch.arange(256, dtype=torch.int32,
                                       device=DEV).expand(4, 256)}
    step = make_train_step(model, lr=1e-3, remat=True)
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_FIXED_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    wall = time.perf_counter() - t0
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train[c]: the fixed-batch loss did not fall: {losses}")
    log(f"train[c]: one fixed batch, {TRAIN_FIXED_STEPS} steps at lr 1e-3: "
        f"losses {[round(x, 4) for x in losses]} (fell "
        f"{100 * (1 - losses[-1] / losses[0]):.1f}%), {wall:.1f} s {tag}")
    del params, opt
    free_models(torch)


def _parity_step(torch, cfg, params, batch):
    """One value_and_grad and one train step of the smoke model: (total,
    loss, aux, grad leaves, updated param leaves) on the CPU."""
    from repro_torch.models import Model
    from repro_torch.train import train_step as ts
    model = Model(cfg)
    (t, (l, a)), grads = ts.value_and_grad(ts.make_loss_fn(model), params,
                                           batch)
    new, _, _ = ts.make_train_step(model, lr=TRAIN_PARITY_LR, remat=False)(
        params, ts.init_opt_state(params), batch)
    cpu = lambda tree: [x.float().cpu() for x in tree_leaves(tree)]
    return float(t), float(l), float(a), cpu(grads), cpu(new)


def train_parity(torch, tag) -> None:
    """(d): one train step at the smoke configs (f32) on the card and on
    the CPU from the same weights and batch: loss and aux within 1e-5,
    every gradient leaf within 1e-4 of its largest magnitude (f32 sums
    in another order: the CPU tests' bound against the reference), the
    updated params within 1e-5, or within 2 lr where the gradient is
    inside that bound (Adam's first step moves a param by ~lr * sign(g),
    so a near-zero gradient may flip)."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    for arch in TRAIN_PARITY_ARCHS:
        cfg = get_smoke_config(arch)
        if arch == "gemma2-9b":
            cfg = dataclasses.replace(cfg, sliding_window=16)
        params = Model(cfg).init_params(seed=0, device="cpu", max_seq=64)
        rng = np.random.default_rng(3)
        B, S = 2, 48
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 "loss_mask": (rng.random((B, S)) < 0.8).astype(np.int64),
                 "positions": np.tile(np.arange(S, dtype=np.int32), (B, 1))}
        res = {}
        for dev in ("card", "cpu"):
            d = DEV if dev == "card" else "cpu"
            b = {k: torch.as_tensor(v, device=d) for k, v in batch.items()}
            res[dev] = _parity_step(torch, cfg, _to_device(params, d), b)
        (tg, lg, ag, gg, pg), (tc, lc, ac, gc_, pc) = res["card"], res["cpu"]
        check(max(abs(tg - tc), abs(lg - lc), abs(ag - ac)) <= 1e-5,
              f"train[d] {arch}: losses card {tg, lg, ag} cpu {tc, lc, ac}")
        g_err, p_err = 0.0, 0.0
        for i, (g1, g2, p1, p2) in enumerate(zip(gg, gc_, pg, pc)):
            tol = max(1e-6, 1e-4 * float(g2.abs().max()))
            e = float((g1 - g2).abs().max())
            check(e <= tol, f"train[d] {arch}: grad leaf {i} {e:.3e} > "
                  f"{tol:.3e}")
            g_err = max(g_err, e / max(float(g2.abs().max()), 1e-30))
            allowed = torch.where(g2.abs() <= tol,
                                  torch.full_like(g2, 2 * TRAIN_PARITY_LR
                                                  + 1e-6),
                                  torch.full_like(g2, 1e-5))
            d = (p1 - p2).abs()
            check(bool((d <= allowed).all()),
                  f"train[d] {arch}: param leaf {i} differs by "
                  f"{float(d.max()):.3e}")
            p_err = max(p_err, float(d.max()))
        log(f"train[d]: {arch} smoke ({cfg.num_layers} layers d{cfg.d_model}"
            f", f32) card vs CPU: loss {lg:.6f} / {lc:.6f}, aux {ag:.3e} / "
            f"{ac:.3e}, {len(gg)} gradient leaves within {g_err:.3e} of "
            f"their max (tol 1e-4), updated params within {p_err:.3e} {tag}")


def _slot_quality(out: str) -> list:
    return [float(m) for m in re.findall(r"^slot +\d+: .*?quality=([0-9.]+)",
                                          out, flags=re.M)]


def train_tiny_serve(torch, ops, tag) -> dict:
    """(e): launch/train_tiny.py at its defaults on the card, then
    cluster_serve --smoke --nodes 2 --slots 2 with and without its
    checkpoint; returns the launches of the three runs."""
    from repro_torch.launch import cluster_serve, train_tiny
    out_path = ROOT / "build" / "train_tiny" / "tiny_lm.npz"
    t0 = time.perf_counter()
    tiny, launches = _count_launches(
        ops, lambda: train_tiny.main(["--out", str(out_path)]))
    wall = time.perf_counter() - t0
    n_attn = tiny["cfg"].num_layers
    steps = tiny["losses"][-1][0] + 1
    want = {"flash_attention": n_attn * steps,
            "flash_attention_bwd": n_attn * steps}
    check({k: c for k, c in launches.items() if c} == want,
          f"train_tiny: launches {launches}, want {want}")
    losses = tiny["losses"]
    check(losses[-1][1] < losses[0][1], f"train_tiny: loss {losses}")
    log(f"train[e]: train_tiny.py ({steps} steps of 16 x 192, "
        f"{tiny['cfg'].name} d{tiny['cfg'].d_model} vocab "
        f"{tiny['cfg'].vocab_size}) in {wall:.1f} s: loss "
        f"{losses[0][1]:.4f} -> {losses[-1][1]:.4f}; launches "
        f"{json.dumps(launches)} {tag}")
    total = dict(launches)
    quality = {}
    for name, extra in (("random", []), ("trained", ["--ckpt",
                                                     str(out_path)])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                _, got = _count_launches(
                    ops, lambda: cluster_serve.main(TINY_CLI + extra))
        finally:
            sys.stdout.write(buf.getvalue())
        text = buf.getvalue()
        check("summary:" in text, f"cluster_serve {extra}: no summary")
        if extra:
            check("node 0 [olmo-1b]: loaded trained weights" in text
                  and "node 1 [xlstm-350m]: ckpt arch/shape mismatch" in text,
                  "cluster_serve --ckpt: node 0 did not load the trained "
                  "weights, or node 1 did")
        quality[name] = _slot_quality(text)
        summary = re.search(r"quality=([0-9.]+)", text.split("summary:")[1])
        quality[name].append(float(summary.group(1)))
        for k, c in got.items():
            total[k] = total.get(k, 0) + c
        log(f"train[e]: cluster_serve {' '.join(TINY_CLI + extra)} in "
            f"{time.perf_counter() - t0:.1f} s; launches {json.dumps(got)}")
    check(len(quality["random"]) == len(quality["trained"]) == 3,
          f"train[e]: slot lines {quality}")
    log("train[e]: mean quality per slot (slot 0, slot 1, summary), "
        f"untrained weights {quality['random']}, with --ckpt "
        f"{quality['trained']} {tag}")
    for f in out_path.parent.glob("tiny_lm*"):
        f.unlink()
    free_models(torch)
    return total


def phase_train(torch, card, rec: dict) -> dict:
    """The training path on the card: (a) the backward kernel against its
    plain version, (b) launch/train.py at olmo-1b's published width, (c)
    a fixed batch's loss falls, (d) card = CPU at the smoke configs, (e)
    train_tiny and cluster_serve --ckpt.  Returns (b)'s and (e)'s
    launches together."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    tag = f"[{card['smi']}]"
    t0 = time.perf_counter()
    train_kernels(torch, F, ops, ref, rec, card)
    t_a = time.perf_counter()
    total = train_launcher(torch, ops, ref, tag,
                           rec["flash_attention_bwd"]["ms"])
    t_b = time.perf_counter()
    train_fixed_batch(torch, tag)
    t_c = time.perf_counter()
    train_parity(torch, tag)
    t_d = time.perf_counter()
    for k, c in train_tiny_serve(torch, ops, tag).items():
        total[k] = total.get(k, 0) + c
    log(f"train: seconds by part (a) {t_a - t0:.1f}, (b) {t_b - t_a:.1f}, "
        f"(c) {t_c - t_b:.1f}, (d) {t_d - t_c:.1f}, (e) "
        f"{time.perf_counter() - t_d:.1f}; launches on the paths "
        f"{json.dumps(total)}")
    return total


SIM_SLO = 15.0           # examples/hierarchical_scheduling_sim.py's --slo
SIM_SLOTS = 20           # its --slots
# three of its six profiling levels (5 .. 30 s): profiling the 2-GPU
# nodes at all six took ~150 s of the script's 1200 s limit
SIM_LEVELS = (5, 15, 30)
SIM_PARITY_SLOTS = 3
SIM_BASELINE_SLOTS = 6
TABLE3_QUERIES = 500     # benchmarks/table3_intra_node.py's N_QUERIES
TABLE3_SLOTS = 2
TABLE3_KINDS = ("small", "mid", "mixed1", "mixed2")


def _sim_slots(n_slots):
    """The example's trace: diurnal volumes (base 300, seed 2) and, per
    slot t, a Dirichlet(2) domain mix from default_rng(t)."""
    import numpy as np
    from repro_torch.data.traces import diurnal_volume_trace
    volumes = diurnal_volume_trace(SIM_SLOTS, base=300, seed=2)[:n_slots]
    return [(int(v), np.random.default_rng(t).dirichlet(np.full(6, 2.0)))
            for t, v in enumerate(volumes)]


def _sim_testbed(caps):
    """A fresh testbed (seed 0) with capacities ``caps`` copied in: they
    are a function of the seeds, as benchmarks/common.py reuses them."""
    from repro_torch.core.cluster import make_paper_testbed
    nodes, qual, w = make_paper_testbed(seed=0)
    for node, cap in zip(nodes, caps):
        node.capacity = cap
    return nodes, qual, w


def _sim_check(m, vol, t, where) -> None:
    import numpy as np
    check(m.n_queries == vol, f"{where} slot {t}: {m.n_queries} queries, "
          f"{vol} sent")
    check(0.0 <= m.quality_mean <= 1.0 and 0.0 <= m.drop_rate <= 1.0,
          f"{where} slot {t}: quality {m.quality_mean}, drop rate "
          f"{m.drop_rate}")
    check(abs(float(np.sum(m.per_node_load)) - 1.0) <= 1e-9,
          f"{where} slot {t}: loads {m.per_node_load} do not sum to 1")


def _busy_ms(trace: Path) -> tuple:
    """(device busy ms, device activities) of a torch.profiler trace: the
    union of its kernel, memcpy and memset intervals."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, None
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in events):
        busy += b - a if end is None else max(0.0, b - max(a, end))
        end = b if end is None else max(end, b)
    return busy / 1e3, len(events)


def phase_sim(torch, card) -> None:
    """examples/hierarchical_scheduling_sim.py through the port, with the
    PPO identifier on the card: (a) the paper's four-node testbed, each
    node profiled and timed; (b) the 20-slot diurnal loop at full size
    through the Coordinator, every slot checked, the identifier and the
    intra-node solve timed and the device's busy share traced; (c) the
    first slots again, card against CPU; (d) the paper's routers and
    fixed deployments on the same trace at a smaller depth."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.core import ppo
    from repro_torch.core.cluster import make_paper_testbed
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.identifier import OnlineQueryIdentifier
    from repro_torch.core.workload import QueryGenerator
    tag = f"[{card['smi']}]"
    t_phase = time.perf_counter()

    # (a) build and profile
    nodes, _, _ = make_paper_testbed(seed=0)
    for node in nodes:
        t0 = time.perf_counter()
        node.profile(levels=SIM_LEVELS)
        cap = node.capacity
        log(f"sim: node {node.node_id} ({node.family}, {node.num_gpus} GPU) "
            f"profiled at {SIM_LEVELS} s in {time.perf_counter() - t0:.3f} "
            f"s: C(L) = {cap.k:.3f} L + {cap.b:.3f}, C({SIM_SLO:g} s) = "
            f"{cap(SIM_SLO):.1f} queries {tag}")
    caps = [node.capacity for node in nodes]

    # (b) the slot loop at full size, the identifier on the card
    from torch.profiler import ProfilerActivity, profile
    slots = _sim_slots(SIM_SLOTS)
    gen = QueryGenerator(seed=1)
    ident = OnlineQueryIdentifier(64, len(nodes), update_threshold=256,
                                  device=DEV)
    initial = bridge.policy_to_numpy(ident.policy)
    coord = Coordinator(nodes, ident, seed=3)
    identify = _CudaTimer(torch, ident.identify)
    ident.identify = identify
    plain_update = ppo.ppo_update
    update = _CudaTimer(torch, plain_update, size_arg=3)
    sched_ms = [[] for _ in nodes]
    for node in nodes:
        def timed(n_queries, budget_s, plain=node.scheduler.schedule,
                  out=sched_ms[node.node_id]):
            t = time.perf_counter()
            alloc = plain(n_queries, budget_s)
            out.append(1e3 * (time.perf_counter() - t))
            return alloc
        node.scheduler.schedule = timed
    trace = ROOT / "build" / "sim_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    walls, history, upd = [], [], []
    ppo.ppo_update = update
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_loop = time.perf_counter()
            for t, (vol, mix) in enumerate(slots):
                qs = gen.sample(vol, mix)
                t0 = time.perf_counter()
                m = coord.run_slot(qs, SIM_SLO)
                walls.append(time.perf_counter() - t0)
                _sim_check(m, vol, t, "sim")
                check(not upd or ident.updates_done >= upd[-1],
                      f"sim slot {t}: updates_done fell")
                upd.append(ident.updates_done)
                history.append(m)
                load = "/".join(f"{p:.3f}" for p in m.per_node_load)
                log(f"sim: slot {t:2d} B {vol:4d} quality "
                    f"{m.quality_mean:.4f} drop rate {m.drop_rate:.4f} load "
                    f"[{load}] wall {walls[-1]:.3f} s, ppo updates "
                    f"{ident.updates_done} {tag}")
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t_loop
    finally:
        ppo.ppo_update = plain_update
    prof.export_chrome_trace(str(trace))
    check(upd[0] > 0, f"no PPO update after slot 0 ({slots[0][0]} queries, "
          "threshold 256)")
    check(sum(v for v, _ in slots) == sum(m.n_queries for m in history),
          "queries lost in the slot loop")
    tensors = list(ident.policy.parameters()) + list(ident.policy.buffers())
    adam = [v for st in ident.opt.state.values() for k, v in st.items()
            if k != "step" and torch.is_tensor(v)]   # step: a host count
    check(len(ident.opt.state) == len(list(ident.policy.parameters()))
          and adam and all(x.device.type == "cuda" for x in tensors + adam),
          "the policy or its Adam state is not on the card")
    k = len(history) // 3
    first = float(np.mean([m.quality_mean for m in history[:k]]))
    last = float(np.mean([m.quality_mean for m in history[-k:]]))
    busy_ms, n_dev = _busy_ms(trace)
    timed_ms = sum(identify.ms) + sum(update.ms)
    log(f"sim: {sum(m.n_queries for m in history)} queries in {SIM_SLOTS} "
        f"slots at SLO {SIM_SLO:g} s in {loop_s:.3f} s (slot wall median "
        f"{statistics.median(walls):.3f} s, min {min(walls):.3f}, max "
        f"{max(walls):.3f}); quality first third {first:.4f}, last third "
        f"{last:.4f}; drop rate mean "
        f"{float(np.mean([m.drop_rate for m in history])):.4f}; PPO updates "
        f"{ident.updates_done} {tag}")
    log(f"sim: identify on the card {_ms(identify.ms)} (host "
        f"{_ms(identify.host_ms)}) {tag}")
    log(f"sim: ppo_update on the card, one epoch at B "
        f"{sorted(set(update.sizes))}: {_ms(update.ms)} (host "
        f"{_ms(update.host_ms)}; {ident.updates_done} updates x "
        f"{ident.update_epochs} epochs) {tag}")
    for node in nodes:
        xs = sched_ms[node.node_id]
        log(f"sim: node {node.node_id} ({node.num_gpus} GPU) "
            f"IntraNodeScheduler.schedule on the host {_ms(xs)}, "
            f"{sum(xs) / 1e3:.3f} s in all ({100 * sum(xs) / 1e3 / loop_s:.1f}"
            f"% of the loop) {tag}")
    # a torch.profiler session after another one in the same process
    # can trace nothing (after --profile's slice pass): then the CUDA
    # events' sum, host gaps inside the calls included, bounds the share
    traced = (f"{busy_ms:.3f} ms ({100 * busy_ms / (loop_s * 1e3):.3f}%, "
              f"{n_dev} device activities traced by torch.profiler)"
              if n_dev else "not traced (the profiler saw no device "
              "activity)")
    log(f"sim: device busy in the {loop_s * 1e3:.1f} ms loop {traced}; "
        f"identify + ppo_update by CUDA events {timed_ms:.3f} ms "
        f"({100 * timed_ms / (loop_s * 1e3):.3f}%, an upper bound) {tag}")

    # (c) parity, card against CPU
    t0 = time.perf_counter()
    sim_parity(torch, caps, initial, tag)
    log(f"sim: parity in {time.perf_counter() - t0:.3f} s")

    # (d) the paper's baselines on the same trace, at a smaller depth
    t0 = time.perf_counter()
    sim_baselines(caps, history, tag)
    log(f"sim: baselines in {time.perf_counter() - t0:.3f} s")
    log(f"sim: phase in {time.perf_counter() - t_phase:.3f} s")


def _sim_run(torch, caps, ident, n_slots, probs_from=None):
    """Slots 0 .. n_slots-1 of the trace on a fresh testbed: the slot
    log [(probs, assignment, results, metrics, updates_done,
    embeddings)].  With
    ``probs_from`` (a log), each slot after the identifier's first update
    is routed on that log's probabilities instead of its own."""
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.workload import QueryGenerator
    nodes, _, _ = _sim_testbed(caps)
    coord = Coordinator(nodes, ident, seed=3)
    gen = QueryGenerator(seed=1)
    out = []
    plain_identify, route, dispatch = ident.identify, coord._route, \
        coord._dispatch
    cur = {}

    def identify(e):
        own = plain_identify(e)
        cur["own"], cur["e"] = own, e
        if probs_from is not None and ident.updates_done > 0:
            return probs_from[len(out)][0]
        return own

    def routed(probs, slo_s):
        assign, props = route(probs, slo_s)
        cur["assign"] = assign.tolist()
        return assign, props

    def dispatched(queries, assign, slo_s):
        res = dispatch(queries, assign, slo_s)
        cur["results"] = [(r.qid, r.node, r.model, r.quality, r.dropped)
                          for r in res]
        return res

    ident.identify, coord._route, coord._dispatch = identify, routed, \
        dispatched
    for t, (vol, mix) in enumerate(_sim_slots(n_slots)):
        m = coord.run_slot(gen.sample(vol, mix), SIM_SLO)
        _sim_check(m, vol, t, "sim parity")
        out.append((cur["own"], cur["assign"], cur["results"],
                    (m.quality_mean, m.drop_rate, m.per_node_load.tolist(),
                     m.n_queries), ident.updates_done, cur["e"]))
    return out


def sim_parity(torch, caps, initial, tag) -> None:
    """The first slots of (b) again, from (b)'s initial policy (carried
    by bridge.policy_to_numpy / policy_from_numpy), on fresh testbeds with
    (a)'s capacities: one identifier on the card, one on the CPU.  Up to
    the first PPO update the CPU routes on its own probabilities, held
    within 1e-5 of the card's, and the assignments, every result and the
    slot metrics are equal.  After it the CPU run routes on the card's
    probabilities, so both see the same feedback: the slots stay equal,
    the policies after the first update are held as runtime_parity holds
    them (policy_parity), and after the last update their parameters
    within 2 lr per Adam step.  The probabilities each side computed
    after the first update are reported, not held."""
    import copy
    import numpy as np
    from repro_torch import bridge
    from repro_torch.core import ppo
    from repro_torch.core.identifier import OnlineQueryIdentifier
    plain_update = ppo.ppo_update
    biases = {"cuda": [], "cpu": []}
    firsts, idents, logs, side = {}, {}, {}, {}

    def recorded(policy, *args, **kw):
        biases[side["now"]].append([layer.b.detach().cpu().clone()
                                    for layer in policy.layers[:-1]])
        return plain_update(policy, *args, **kw)

    ppo.ppo_update = recorded
    try:
        for name, dev in (("cuda", DEV), ("cpu", "cpu")):
            side["now"] = name
            ident = OnlineQueryIdentifier(64, len(caps), update_threshold=256,
                                          device=dev)
            ident.load_policy(bridge.policy_from_numpy(initial, dev))
            plain = ident.maybe_update

            def update_once(plain=plain, ident=ident, name=name):
                out = plain()
                if ident.updates_done == 1 and name not in firsts:
                    firsts[name] = copy.deepcopy(ident.policy).cpu()
                return out
            ident.maybe_update = update_once
            idents[name] = ident
            logs[name] = _sim_run(torch, caps, ident, SIM_PARITY_SLOTS,
                                  logs.get("cuda"))
    finally:
        ppo.ppo_update = plain_update
    card, cpu = logs["cuda"], logs["cpu"]
    raw = []
    for t, (g, c) in enumerate(zip(card, cpu)):
        err = float(np.abs(g[0] - c[0]).max())
        if t == 0 or card[t - 1][4] == 0:      # routed before any update
            check(err <= 1e-5, f"sim parity slot {t}: probabilities "
                  f"{err:.3g} apart before any update (tol 1e-5)")
        else:
            raw.append(err)
        check(g[1:5] == c[1:5], f"sim parity slot {t}: assignments, "
              "results or metrics differ on the card and the CPU")
    check(card[0][4] == 1, f"sim parity: {card[0][4]} updates after slot 0")
    epochs = idents["cpu"].update_epochs
    n_ep = card[-1][4] * epochs
    check(len(biases["cuda"]) == len(biases["cpu"]) == n_ep,
          f"sim parity: {len(biases['cuda'])} / {len(biases['cpu'])} PPO "
          f"epochs recorded, {n_ep} expected")
    probe = torch.as_tensor(np.asarray(card[0][5], np.float32))
    par = policy_parity(torch, firsts["cuda"], firsts["cpu"],
                        {d: b[:epochs] for d, b in biases.items()}, probe,
                        epochs, idents["cpu"].lr)
    end = policy_parity(torch, idents["cuda"].policy, idents["cpu"].policy,
                        biases, probe, n_ep, idents["cpu"].lr)
    log(f"sim: parity over {SIM_PARITY_SLOTS} slots "
        f"({sum(len(g[2]) for g in card)} queries), card vs CPU: "
        f"probabilities before the first update "
        f"{float(np.abs(card[0][0] - cpu[0][0]).max()):.3g} apart (tol "
        f"1e-5), assignments, results and slot metrics equal; "
        f"after the first update each side's own probabilities "
        f"{[f'{x:.3g}' for x in raw]} apart (not held; the CPU routed on "
        f"the card's); the policies after the first update: {par['text']}; "
        f"after the last ({n_ep} epochs) params max |err| "
        f"{end['params_err']:.3g} (tol {2 * idents['cpu'].lr * n_ep:.3g}) "
        f"{tag}")
    check(par["ok"], "sim parity: the policies after the first update "
          "differ")
    check(end["params_err"] <= 2 * idents["cpu"].lr * n_ep,
          "sim parity: the policies' parameters after the last update "
          "differ")


def sim_baselines(caps, history, tag) -> None:
    """Table II's routers over the trace's first slots (Random and LinUCB
    through the Coordinator, the oracle by argmax of
    OracleAllocator.probs_for_domains, as benchmarks/table2_allocation.py
    drives it), and Table III's shape: node 3 (2 GPUs) under the OCO
    schedule and the four fixed deployments at 500 queries and the SLO's
    budget.  Holds what tests/test_ppo_and_sim.py holds: the oracle's
    quality beats random's by more than 0.02."""
    import numpy as np
    from repro_torch.core.baselines import (FixedDeploymentScheduler,
                                            LinUCBAllocator,
                                            OracleAllocator, RandomAllocator)
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.protocols import QueryRouter
    from repro_torch.core.workload import QueryGenerator
    slots = _sim_slots(SIM_BASELINE_SLOTS)
    quality = {}

    def served(results):
        ok = [r.quality for r in results if not r.dropped]
        return (float(np.mean(ok)) if ok else 0.0,
                float(np.mean([r.dropped for r in results])),
                float(np.mean([r.quality for r in results])))

    for name in ("random", "linucb", "oracle"):
        t0 = time.perf_counter()
        nodes, qual, _ = _sim_testbed(caps)
        gen = QueryGenerator(seed=1)
        rows = []
        if name == "oracle":
            orc = OracleAllocator(qual)
            for vol, mix in slots:
                qs = gen.sample(vol, mix)
                assign = orc.probs_for_domains([q.domain for q in qs]
                                               ).argmax(1)
                res = []
                for n, node in enumerate(nodes):
                    res += node.process_slot(
                        [qs[i] for i in np.where(assign == n)[0]], SIM_SLO)
                check(len(res) == vol, f"oracle: {len(res)} results of {vol}")
                rows.append(served(res))
        else:
            router = RandomAllocator(len(nodes), seed=2) if name == "random" \
                else LinUCBAllocator(64, len(nodes), seed=2)
            check(isinstance(router, QueryRouter),
                  f"{name} is not a QueryRouter")
            coord = Coordinator(nodes, router, seed=3)
            res_all = []
            dispatch = coord._dispatch

            def kept(queries, assign, slo_s, dispatch=dispatch,
                     res_all=res_all):
                res = dispatch(queries, assign, slo_s)
                res_all.append(res)
                return res
            coord._dispatch = kept
            for t, (vol, mix) in enumerate(slots):
                m = coord.run_slot(gen.sample(vol, mix), SIM_SLO)
                _sim_check(m, vol, t, name)
                rows.append(served(res_all[-1]))
        q, d, w = (float(np.mean([r[i] for r in rows])) for i in range(3))
        quality[name] = q
        log(f"sim: Table II shape, {name} over {len(slots)} slots "
            f"({sum(v for v, _ in slots)} queries): quality of served "
            f"queries {q:.4f}, drop rate {d:.4f}, quality with drops as 0 "
            f"{w:.4f} ({time.perf_counter() - t0:.3f} s) {tag}")
    ppo_q = float(np.mean([m.quality_mean for m in history[:len(slots)]]))
    log(f"sim: Table II shape, PPO in (b)'s first {len(slots)} slots "
        f"(its testbed after profiling): quality of served queries "
        f"{ppo_q:.4f} {tag}")
    check(quality["oracle"] > quality["random"] + 0.02,
          f"oracle quality {quality['oracle']:.4f} does not beat random "
          f"{quality['random']:.4f} by more than 0.02")
    for kind in (None,) + TABLE3_KINDS:
        t0 = time.perf_counter()
        nodes, _, _ = _sim_testbed(caps)
        node = nodes[3]
        sched = None if kind is None else FixedDeploymentScheduler(node, kind)
        gen = QueryGenerator(seed=1)
        rows = [served(node.process_slot(gen.sample(TABLE3_QUERIES), SIM_SLO,
                                         scheduler=sched))
                for _ in range(TABLE3_SLOTS)]
        q, d, w = (float(np.mean([r[i] for r in rows])) for i in range(3))
        log(f"sim: Table III shape, node 3 ({node.num_gpus} GPU) "
            f"{kind or 'OCO intra-node'} at {TABLE3_QUERIES} queries x "
            f"{TABLE3_SLOTS} slots, SLO {SIM_SLO:g} s: quality of served "
            f"queries {q:.4f}, drop rate {d:.4f}, quality with drops as 0 "
            f"{w:.4f} ({time.perf_counter() - t0:.3f} s) {tag}")


def profile_slice(torch, rag, qs, tag) -> list:
    """One more pass of the slice under torch.profiler: the device's busy
    share of the traced window (union of kernel, memcpy and memset
    intervals over the span of all traced events) and device time by
    kernel.  The profiler's own host overhead lowers the busy share.
    Returns the names of the device kernels the pass ran, in order."""
    from torch.profiler import ProfilerActivity, profile
    trace = ROOT / "build" / "slice_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rag.answer(qs)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(dev), "the profiler traced no device activity")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, end = 0.0, t0
    by_name = {}
    for a, b, e in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    total = sum(by_name.values())
    log(f"profile: traced {(t1 - t0) / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / (t1 - t0):.1f}%), "
        f"{len(dev)} device activities {tag}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {100 * us / total:5.1f}% {us / 1e3:8.2f} ms  {name[:90]}")
    mine = re.compile(r"\b(paged_decode_kernel|paged_combine_kernel|"
                      r"flash_kernel|flash_mma_kernel|"
                      r"topk_scan_kernel|topk_merge_kernel|"
                      r"ivf_scan_kernel|ivf_merge_kernel)\b")
    ours = sum(us for name, us in by_name.items() if mine.search(name))
    log(f"profile: the port's CUDA kernels {ours / 1e3:.2f} ms "
        f"({100 * ours / total:.1f}% of device time)")
    return [e["name"] for _, _, e in dev if e.get("cat") == "kernel"]


def _paged_case(torch, gen, B, H, KV, hd, bs, P, lengths, firsts, nb,
                dtype, all_free_row=False):
    dev = DEV
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, bs, KV, hd, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, bs, KV, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P, generator=gen, device=dev)
    tables = torch.full((B, nb), -1, dtype=torch.int32, device=dev)
    used = 0
    for b in range(B):
        n = -(-(lengths[b] + 1) // bs)
        if all_free_row and b == B - 1:
            continue
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    first = torch.tensor(firsts, dtype=torch.int32, device=dev)
    last = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, first, last


def _paged_library(torch, F, q, kp, vp, tb, fi, la):
    """Yardstick: SDPA over the K/V gathered out of the pool (the gather
    is done here, untimed); GQA by repeating the KV heads."""
    B, H, hd = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    nb = tb.shape[1]
    tbl = tb.long().clamp(0, kp.shape[0] - 1)
    kg = kp[tbl].reshape(B, nb * bs, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2)
    vg = vp[tbl].reshape(B, nb * bs, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2)
    pos = torch.arange(nb * bs, device=DEV)[None]
    mask = ((pos >= fi[:, None]) & (pos <= la[:, None])
            & (tb >= 0).repeat_interleave(bs, 1))[:, None, None, :]
    qs = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, kg, vg, attn_mask=mask)


def _paged_times(torch, F, ops, ref, args, kw, label, card, splits=()):
    """Kernel (the wrapper's split rule), plain and library times of one
    paged decode call, and the kernel at forced split counts."""
    q, kp, vp, tb, fi, la = args
    B, H, hd = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    nb = tb.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule = ops.paged_decode_splits(B, KV, nb, sms)
    t_k = bench_ms(lambda: ops.paged_decode_attention(*args, **kw))
    t_p = bench_ms(lambda: ref.paged_attention_ref(*args, **kw))
    t_l = bench_ms(_paged_library(torch, F, *args))
    forced = {n: bench_ms(lambda n=n: ops._paged_launch(
        *args, kw.get("softcap"), n)) for n in splits}
    nbytes, flops = paged_work(q, kp, tb, fi, la)
    bnd, by = bound_ms(nbytes, flops, dtype_name(q))
    log(f"  paged_decode_attention {label} B{B} H{H} KV{KV} hd{hd} bs{bs} "
        f"nb{nb}: kernel {t_k:.4f} ms ({rule} splits by the rule), plain "
        f"{t_p:.4f} ms, SDPA(gathered) {t_l:.4f} ms, bound {bnd:.5f} ms "
        f"({by}, {nbytes} bytes) [{card['smi']}]")
    if forced:
        log(f"  paged_decode_attention {label} forced splits: " + ", ".join(
            f"{n}: {t:.4f} ms" for n, t in forced.items()))
    return t_k, t_p, t_l, bnd, by


def _paged_check(torch, ops, ref, name, args, cap, n_splits=None):
    q = args[0]
    if n_splits is None:
        got = ops.paged_decode_attention(*args, softcap=cap)
    else:
        got = ops._paged_launch(*args, cap, n_splits)
        name = f"{name}, {n_splits} splits"
    want = ref.paged_attention_ref(*args, softcap=cap)
    torch.cuda.synchronize()
    err, tol = max_err(got, want), tolerance(want)
    log(f"  paged_decode_attention [{name}] {tuple(q.shape)} "
        f"{dtype_name(q)} max|err| {err:.3e} (tol {tol:.3g})")
    check(bool(torch.isfinite(got).all()), f"paged decode {name}: non-finite")
    check(err <= tol, f"paged decode {name}: {err} > {tol}")
    return err


def kernels_paged(torch, F, ops, ref, gen, main, rec, card) -> None:
    bf16, f32 = torch.bfloat16, torch.float32
    synth = _paged_case(torch, gen, 4, 16, 16, 128, 16, 128,
                        [150, 171, 118, 190], [3, 0, 14, 7], 12, bf16)
    if main is None:
        main = (synth, {"softcap": None})
    # B 1 with a 2048-token context: 128 columns cross every warp and
    # block split
    long1 = _paged_case(torch, gen, 1, 16, 16, 128, 16, 128, [2047], [0],
                        128, bf16)
    # first mid-block (21, 37), one row live inside one block (35..40)
    midblock = _paged_case(torch, gen, 3, 16, 16, 128, 16, 40,
                           [150, 40, 200], [21, 35, 37], 13, bf16)
    cases = [
        ("main path", main[0], main[1]["softcap"]),
        ("bf16 H=KV=16 hd128 bs16", synth, None),
        ("f32 hd16", _paged_case(torch, gen, 3, 4, 4, 16, 8, 10,
                                 [20, 9, 30], [2, 0, 5], 4, f32), None),
        ("gqa H4 KV2 f32", _paged_case(torch, gen, 3, 4, 2, 16, 8, 10,
                                       [20, 9, 30], [2, 0, 5], 4, f32),
         None),
        ("softcap 30 f32", _paged_case(torch, gen, 3, 4, 2, 32, 8, 10,
                                       [20, 9, 30], [2, 0, 5], 4, f32),
         30.0),
        ("hd8 bf16 gqa", _paged_case(torch, gen, 2, 4, 1, 8, 4, 8,
                                     [9, 5], [0, 1], 3, bf16), None),
        ("bf16 gqa H8 KV2", _paged_case(torch, gen, 3, 8, 2, 128, 16, 40,
                                        [150, 61, 200], [3, 0, 17], 13,
                                        bf16), None),
        ("bf16 softcap 30", _paged_case(torch, gen, 3, 16, 16, 128, 16, 40,
                                        [150, 61, 200], [3, 0, 17], 13,
                                        bf16), 30.0),
        ("bf16 hd16", _paged_case(torch, gen, 3, 4, 4, 16, 16, 40,
                                  [150, 61, 200], [3, 0, 17], 13, bf16),
         None),
        ("bf16 hd64", _paged_case(torch, gen, 3, 8, 8, 64, 16, 40,
                                  [150, 61, 200], [3, 0, 17], 13, bf16),
         None),
        ("bf16 first mid-block, a range inside one block", midblock, None),
        # hd not a multiple of a 16-byte chunk: element loads
        ("bf16 hd12 gqa, element loads",
         _paged_case(torch, gen, 3, 4, 2, 12, 16, 40, [150, 61, 200],
                     [3, 0, 17], 13, bf16), None),
        ("f32 hd10, element loads",
         _paged_case(torch, gen, 3, 4, 4, 10, 8, 10, [20, 9, 30], [2, 0, 5],
                     4, f32), None),
        ("bf16 B1 2048-token context", long1, None),
    ]
    errs = {}
    for name, args, cap in cases:
        errs[name] = _paged_check(torch, ops, ref, name, args, cap)
    for n in (1, 3, 16):
        _paged_check(torch, ops, ref, "bf16 B1 2048-token context", long1,
                     None, n_splits=n)
    _paged_check(torch, ops, ref, "bf16 first mid-block, a range inside one "
                 "block", midblock, None, n_splits=4)
    # a row whose table is all -1 must stay finite
    q, kp, vp, tb, fi, la = _paged_case(torch, gen, 2, 2, 1, 8, 4, 4, [5, 0],
                                        [0, 0], 2, f32, all_free_row=True)
    got = ops.paged_decode_attention(q, kp, vp, tb, fi, la)
    want = ref.paged_attention_ref(q, kp, vp, tb, fi, la)
    check(bool(torch.isfinite(got).all()), "all-unallocated row not finite")
    err = max_err(got[0], want[0])
    log(f"  paged_decode_attention [all-unallocated row] finite, row 0 "
        f"max|err| {err:.3e} (tol 2e-05)")
    check(err <= 2e-5, f"paged decode unallocated row: {err}")

    args, kw = main
    _deterministic(torch, lambda: ops.paged_decode_attention(*args, **kw),
                   "paged_decode_attention")
    t_k, t_p, t_l, bnd, by = _paged_times(torch, F, ops, ref, args, kw,
                                          "main path", card, (1, 2, 3, 4))
    rec.setdefault("paged_decode_attention", {}).update(
        max_abs_err=errs["main path"], ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_l)
    _paged_times(torch, F, ops, ref, long1, {}, "B1 2048-token context",
                 card, (1, 4, 8, 16))
    # serving scale: 32 rows of 2048 tokens, ~537 MB of K/V
    big = _paged_case(torch, gen, 32, 16, 16, 128, 16, 32 * 128,
                      [2047] * 32, [0] * 32, 128, bf16)
    _paged_check(torch, ops, ref, "bf16 B32 2048-token contexts", big, None)
    _paged_times(torch, F, ops, ref, big, {}, "B32 2048-token contexts",
                 card, (1, 2))
    del big


def _deterministic(torch, fn, name) -> None:
    a, b = fn(), fn()
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{name}: two calls on the same inputs differ")
    log(f"  {name} [determinism] two calls on the main-path inputs are "
        "bitwise equal")


def _flash_case(torch, gen, B, Sq, Sk, H, KV, hd, dtype, past, pads,
                lead=None):
    """Chunked-prefill shaped inputs: row b has ``past[b]`` cached keys at
    relative positions 0.. (after ``lead[b]`` unwritten slots), its chunk
    queries follow them (the first ``pads[b]`` chunk columns are pads,
    position -1); unwritten slots of the gathered buffer carry -1."""
    dev = DEV
    lead = lead or [0] * B
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    nbuf = Sk - Sq
    kv_pos = torch.full((B, Sk), -1, dtype=torch.int32)
    q_pos = torch.full((B, Sq), -1, dtype=torch.int32)
    for b in range(B):
        kv_pos[b, lead[b]:lead[b] + past[b]] = torch.arange(past[b])
        real = torch.arange(past[b], past[b] + Sq - pads[b])
        q_pos[b, pads[b]:] = real
        kv_pos[b, nbuf + pads[b]:] = real
    return q, k, v, q_pos.to(dev), kv_pos.to(dev)


def _flash_library(torch, F, q, k, v, qp, kvp, causal=True, window=None,
                   softcap=None):
    """Yardstick: SDPA with the position mask as a bool mask (GQA by
    repeating the KV heads; no softcap form exists, so it is left out)."""
    G = q.shape[2] // k.shape[2]
    kp, qq = kvp[:, None, :], qp[:, :, None]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qq)
    if window:
        mask = mask & (qq - kp < window)
    qt = q.transpose(1, 2)
    kt, vt = (x.repeat_interleave(G, dim=2).transpose(1, 2) for x in (k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask[:, None])


def _flash_times(torch, F, ops, ref, args, kw, label, card):
    q, k, v, qp, kvp = args
    t_k = bench_ms(lambda: ops.flash_attention(*args, **kw))
    t_p = bench_ms(lambda: ref.flash_attention_ref(*args, **kw))
    t_l = bench_ms(_flash_library(torch, F, *args, **kw))
    nbytes, flops = flash_work(q, k, qp, kvp, kw.get("causal", True),
                               kw.get("window"))
    bnd, by = bound_ms(nbytes, flops, dtype_name(q))
    log(f"  flash_attention {label} q{tuple(q.shape)} k{tuple(k.shape)}: "
        f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, SDPA(bool mask) "
        f"{t_l:.4f} ms, bound {bnd:.5f} ms ({by}, {nbytes} bytes, {flops} "
        f"flops) [{card['smi']}]")
    return t_k, t_p, t_l, bnd, by


def kernels_flash(torch, F, ops, ref, gen, main, rec, card) -> None:
    bf16, f32 = torch.bfloat16, torch.float32
    # olmo-1b chunked prefill: 4 rows, C = 16 queries against the gathered
    # 32-block table (512 slots) + the chunk, bf16
    synth = _flash_case(torch, gen, 4, 16, 528, 16, 16, 128, bf16,
                        [96, 0, 160, 48], [0, 5, 0, 11])
    if main is None:
        main = (synth, {"causal": True, "window": None, "softcap": None})
    chunk = [96, 0, 160, 48], [0, 5, 0, 11]
    cases = [
        ("main path", main[0], main[1]),
        ("bf16 H=KV=16 hd128 Sq16 Sk528", synth, {}),
        ("f32 hd16 gqa", _flash_case(torch, gen, 2, 8, 40, 4, 2, 16, f32,
                                     [10, 3], [0, 2]), {}),
        ("softcap 30 f32", _flash_case(torch, gen, 2, 8, 40, 4, 2, 32, f32,
                                       [10, 3], [0, 2]), {"softcap": 30.0}),
        ("window 5 f32", _flash_case(torch, gen, 2, 8, 40, 4, 4, 16, f32,
                                     [10, 3], [1, 0]), {"window": 5}),
        ("hd8 bf16", _flash_case(torch, gen, 1, 16, 48, 2, 1, 8, bf16,
                                 [20], [3]), {}),
        ("bf16 gqa H8 KV2", _flash_case(torch, gen, 4, 16, 528, 8, 2, 128,
                                        bf16, *chunk), {}),
        ("bf16 softcap 30", _flash_case(torch, gen, 4, 16, 528, 16, 16, 128,
                                        bf16, *chunk), {"softcap": 30.0}),
        ("bf16 window 5", _flash_case(torch, gen, 4, 16, 528, 16, 16, 128,
                                      bf16, *chunk), {"window": 5}),
        ("bf16 hd16", _flash_case(torch, gen, 4, 16, 528, 4, 4, 16, bf16,
                                  *chunk), {}),
        ("bf16 hd64", _flash_case(torch, gen, 4, 16, 528, 8, 8, 64, bf16,
                                  *chunk), {}),
        ("bf16 Sq13", _flash_case(torch, gen, 3, 13, 141, 8, 8, 128, bf16,
                                  [40, 0, 100], [0, 4, 2]), {}),
        ("bf16 Sq40 gqa", _flash_case(torch, gen, 3, 40, 296, 8, 2, 128,
                                      bf16, [40, 0, 200], [0, 4, 2]), {}),
        ("bf16 Sq40 window 5 softcap 30",
         _flash_case(torch, gen, 3, 40, 296, 8, 8, 64, bf16, [40, 0, 200],
                     [0, 4, 2]), {"window": 5, "softcap": 30.0}),
        ("bf16 live keys from mid-tile",
         _flash_case(torch, gen, 3, 16, 528, 16, 16, 128, bf16,
                     [96, 30, 160], [0, 3, 0], lead=[37, 75, 21]), {}),
        ("bf16 non-causal", _flash_case(torch, gen, 2, 16, 80, 4, 4, 64,
                                        bf16, [30, 10], [0, 3]),
         {"causal": False}),
        # hd not a multiple of a 16-byte chunk: element loads
        ("bf16 hd12 gqa, element loads",
         _flash_case(torch, gen, 2, 16, 80, 4, 2, 12, bf16, [30, 10],
                     [0, 3]), {}),
        ("bf16 hd12 Sq40, element loads",
         _flash_case(torch, gen, 2, 40, 104, 4, 4, 12, bf16, [30, 10],
                     [0, 3]), {}),
    ]
    errs = {}
    for name, (q, k, v, qp, kvp), kw in cases:
        got = ops.flash_attention(q, k, v, qp, kvp, **kw)
        want = ref.flash_attention_ref(q, k, v, qp, kvp, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
        rows = (qp >= 0)[:, :, None, None].expand_as(got)
        err, tol = max_err(got, want, rows), tolerance(want)
        errs[name] = err
        log(f"  flash_attention [{name}] q{tuple(q.shape)} k{tuple(k.shape)}"
            f" {dtype_name(q)} valid rows max|err| {err:.3e} (tol "
            f"{tol:.3g}); every row finite")
        check(err <= tol, f"flash {name}: {err} > {tol}")
    # the TPU kernel's right-aligned interface
    qa = torch.randn(1, 2, 17, 8, generator=gen, device=DEV)
    ka = torch.randn(1, 2, 33, 8, generator=gen, device=DEV)
    va = torch.randn(1, 2, 33, 8, generator=gen, device=DEV)
    for causal in (True, False):
        got = ops.flash_attention_aligned(qa, ka, va, causal=causal)
        want = F.scaled_dot_product_attention(
            qa, ka, va, attn_mask=None if not causal else
            torch.ones(17, 33, dtype=torch.bool, device=DEV).tril(16))
        err = max_err(got, want)
        log(f"  flash_attention_aligned [causal={causal}] vs SDPA max|err| "
            f"{err:.3e} (tol 2e-05)")
        check(err <= 2e-5, f"aligned flash causal={causal}: {err}")

    args, kw = main
    _deterministic(torch, lambda: ops.flash_attention(*args, **kw),
                   "flash_attention")
    t_k, t_p, t_l, bnd, by = _flash_times(torch, F, ops, ref, args, kw,
                                          "main path", card)
    rec.setdefault("flash_attention", {}).update(
        max_abs_err=errs["main path"], ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_l)
    # a 256-query chunk after 1792 cached keys
    big = _flash_case(torch, gen, 4, 256, 2048, 16, 16, 128, bf16,
                      [1792] * 4, [0] * 4)
    q, k, v, qp, kvp = big
    got = ops.flash_attention(*big)
    want = ref.flash_attention_ref(*big)
    torch.cuda.synchronize()
    err, tol = max_err(got, want), tolerance(want)
    log(f"  flash_attention [bf16 Sq256 after 1792 keys] max|err| {err:.3e} "
        f"(tol {tol:.3g})")
    check(err <= tol, f"flash Sq256: {err} > {tol}")
    _flash_times(torch, F, ops, ref, big, {}, "Sq256 after 1792 keys", card)


def _topk_check(torch, ops, ref, q, d, k, name, tol=1e-5, fn=None):
    """``fn`` (q, d, k) in place of the routed ops.retrieval_topk: a
    kernel forced at its plan."""
    s, i = (fn or ops.retrieval_topk)(q, d, k)
    s2, i2 = ref.topk_ref(q, d, k)
    torch.cuda.synchronize()
    err = max_err(s, s2)
    same = i == i2
    check(_ids_agree(torch, s2, i, i2, tol), f"top-k {name}: ids differ")
    log(f"  retrieval_topk [{name}] Nq{q.shape[0]} Nd{d.shape[0]} "
        f"D{q.shape[1]} k{k} scores max|err| {err:.3e} (tol {tol:g}), ids "
        f"equal {int(same.sum())}/{same.numel()}")
    check(err <= tol, f"top-k {name}: {err} > {tol}")
    return s, i, err


def _topk_times(torch, ops, ref, q, d, k, label, card):
    t_k = bench_ms(lambda: ops.retrieval_topk(q, d, k))
    t_p = bench_ms(lambda: ref.topk_ref(q, d, k))
    t_l = bench_ms(lambda: torch.topk(q @ d.T, k))
    nbytes, flops = topk_work(q, d, k)
    bnd, by = bound_ms(nbytes, flops, "float32")
    log(f"  retrieval_topk {label} Nq{q.shape[0]} Nd{d.shape[0]} "
        f"D{q.shape[1]} k{k}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"topk(q@d.T) {t_l:.4f} ms, bound {bnd:.5f} ms ({by}), "
        f"{100 * bnd / t_k:.1f}% of the bound [{card['smi']}]")
    return t_k, t_p, t_l, bnd, by


def _topk_same_twice(torch, ops, q, d, k, label, fn=None) -> None:
    fn = fn or ops.retrieval_topk
    (s1, i1), (s2, i2) = fn(q, d, k), fn(q, d, k)
    torch.cuda.synchronize()
    check(torch.equal(s1, s2) and torch.equal(i1, i2),
          f"retrieval_topk {label}: two calls on the same inputs differ")
    log(f"  retrieval_topk [determinism] two calls on the {label} inputs "
        "are bitwise equal")


def _device_kernels(torch, fn) -> list:
    """Names of the device kernels one call of ``fn`` runs, from a
    torch.profiler trace (each logged with its traced device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = ROOT / "build" / "topk_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    for e in kernels:
        log(f"  [profile] {float(e['dur']):.1f} us  {e['name'][:80]}")
    return [e["name"] for e in kernels]


def _topk_dup_case(torch, ops, ref, gen, sms) -> None:
    """Equal doc rows across a tile boundary, a split boundary and far
    apart, in a corpus the split rule cuts: each query's best row appears
    two or three times, and its ids must come out lowest first."""
    nd = 20_000
    _, n_splits, per = ops.retrieval_topk_plan(4, nd, sms)
    tile = ops.TOPK_TILE
    d = torch.randn(nd, 64, generator=gen, device=DEV)
    d = d / d.norm(dim=1, keepdim=True)
    dups = [(tile - 1, tile), (per - 1, per, 2 * per + tile),
            (5, nd - 1), (per + 3, 3 * per + 3)]
    for g in dups:
        d[list(g[1:])] = d[g[0]].clone()
    q = torch.stack([2.0 * d[g[0]] for g in dups])
    s, i, _ = _topk_check(torch, ops, ref, q, d, 4,
                          f"ties across tiles and {n_splits} splits")
    for row, g in enumerate(dups):
        check(i[row, :len(g)].tolist() == list(g)
              and bool((s[row, :len(g)] == s[row, 0]).all()),
              f"ties must go to the lowest doc id: row {row} "
              f"{i[row].tolist()} vs {g}")


def _topk_forced_splits(torch, ops, q, d, k, counts, label, card) -> None:
    """The kernel with the docs cut into about ``counts`` splits instead
    of the rule's: results bitwise equal to the rule's (a doc scores the
    same in every split), and the time of each count."""
    tile = ops.TOPK_TILE
    s0, i0 = ops.retrieval_topk(q, d, k)
    times = []
    for want in counts:
        per = -(-(-(-d.shape[0] // tile)) // want) * tile
        n = -(-d.shape[0] // per)
        s, i = ops._topk_launch(q, d, k, n, per)
        torch.cuda.synchronize()
        check(torch.equal(s, s0) and torch.equal(i, i0),
              f"retrieval_topk {label}: {n} splits differ from the rule's")
        t = bench_ms(lambda: ops._topk_launch(q, d, k, n, per))
        times.append(f"{n}: {t:.4f}")
    log(f"  retrieval_topk {label} Nq{q.shape[0]} forced splits (bitwise "
        f"equal to the rule's) ms {', '.join(times)} [{card['smi']}]")


# topk.cu knobs (-D) of the exploratory sweep, by name
TOPK_VARIANTS = {
    "as built": [],
    "3 stages": ["-DTOPK_STAGES=3"],
    "4 stages": ["-DTOPK_STAGES=4"],
    "chunk 64 dims": ["-DTOPK_KC=64"],
    "chunk 64 dims, 3 stages": ["-DTOPK_KC=64", "-DTOPK_STAGES=3"],
    "no L2 256B hint": ["-DTOPK_L2_256B=0"],
}


def kernel_sweep(torch, ops, lib, entry, variants, call, cases,
                 card) -> None:
    """Rebuild csrc/<lib>.cu once per ``variants`` entry {name: nvcc -D
    flags} (in parallel), and for each put it in the place of the built
    entry point ``entry``: check that ``call`` (the ops wrapper) gives
    bitwise the built kernel's results on ``cases`` {label: args} (the
    knobs keep every sum's order), and time it there."""
    import ctypes
    from repro_torch.kernels import build
    out = ROOT / "build" / f"{lib}_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants.items():
        so = out / f"lib{len(procs)}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(so),
             str(build.CSRC / build.SOURCES[lib])], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    want = {label: call(*args) for label, args in cases.items()}
    built = ops._fn(lib, entry)
    try:
        for name, (so, proc) in procs.items():
            text = proc.communicate()[0]
            check(proc.returncode == 0, f"{lib} sweep {name}: nvcc\n{text}")
            fn = getattr(ctypes.CDLL(str(so)), entry)
            fn.argtypes = ops._SIGNATURES[(lib, entry)]
            fn.restype = ctypes.c_int
            ops._FNS[entry] = fn
            times = []
            for label, args in cases.items():
                s, i = call(*args)
                torch.cuda.synchronize()
                check(torch.equal(s, want[label][0])
                      and torch.equal(i, want[label][1]),
                      f"{lib} sweep {name} {label}: differs from the built "
                      "kernel")
                times.append(f"{label} {bench_ms(lambda: call(*args)):.4f}")
            log(f"  {entry} sweep [{name}] ms: {', '.join(times)} "
                f"[{card['smi']}]")
    finally:
        ops._FNS[entry] = built


# ivf_topk.cu knobs (-D) of the exploratory sweep, by name
IVF_VARIANTS = {
    "as built": [],
    "2 stages": ["-DIVF_STAGES=2"],
    "chunk 64 dims, 2 stages": ["-DIVF_KC=64", "-DIVF_STAGES=2"],
    "no L2 256B hint": ["-DIVF_L2_256B=0"],
}


def _topk_main(torch, gen, main):
    """The exact top-k's main-path inputs (q, d, k): the recorded ones, or
    8 questions against the 240-chunk corpus at k 3."""
    if main is not None:
        return main[0]
    q, d = (torch.randn(n, 256, generator=gen, device=DEV)
            for n in (8, 240))
    return q / q.norm(dim=1, keepdim=True), d / d.norm(dim=1, keepdim=True), 3


def kernels_topk(torch, ops, ref, gen, main, shard, rec, card,
                 profiled) -> None:
    """``profiled``: (what, names of the device kernels it ran), the
    main-path call traced under torch.profiler."""
    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qm, dm, km = main
    log(f"  retrieval_topk plan (groups, splits, docs per split): main "
        f"path {ops.retrieval_topk_plan(qm.shape[0], dm.shape[0], sms)}, "
        f"1M docs Nq32 {ops.retrieval_topk_plan(32, SHARD_DOCS, sms)}")
    _, _, err_main = _topk_check(torch, ops, ref, qm, dm, km, "main path")
    base = torch.randn(6, 16, generator=gen, device=DEV)
    dup = torch.cat([base, base, base])          # ids i, i+6, i+12 tie
    s, i, _ = _topk_check(torch, ops, ref, base[:4] * 2.0, dup, 4, "ties")
    check(bool((i[:, 0] == torch.arange(4, device=DEV)).all())
          and bool((i[:, 1] == torch.arange(4, device=DEV) + 6).all()),
          "ties must go to the lowest doc id")
    _topk_dup_case(torch, ops, ref, gen, sms)
    s, i, _ = _topk_check(torch, ops, ref, unit(4, 8), unit(3, 8), 5,
                          "k > Nd")
    check(bool((i[:, 3:] == -1).all()) and bool((s[:, 3:] <= -1e29).all()),
          "k > Nd must fill (-1e30, -1)")
    _topk_check(torch, ops, ref, unit(33, 64), unit(4097, 64), 32, "ragged")
    _topk_check(torch, ops, ref, unit(65, 64), unit(3001, 64), 7, "Nq 65")
    # a short split for <= 8 queries spreads its docs over the warps; their
    # 4 lists of k merge at once when they fit one 64-entry buffer (k 16),
    # else one at a time (k 17)
    _topk_check(torch, ops, ref, unit(8, 64), unit(500, 64), 16,
                "spread, k 16")
    _topk_check(torch, ops, ref, unit(8, 64), unit(500, 64), 17,
                "spread, k 17")
    _topk_check(torch, ops, ref, unit(5, 30), unit(2000, 30), 6, "D 30")
    s, i, _ = _topk_check(torch, ops, ref, unit(3, 16), unit(1, 16), 3,
                          "Nd 1")
    check(bool((i[:, 0] == 0).all()) and bool((i[:, 1:] == -1).all()),
          "Nd 1: one doc, then the fill")
    flat = unit(1, 12 * 256 + 1).view(-1)[1:]     # 4 bytes off 16
    _topk_check(torch, ops, ref, flat[:256].view(1, 256),
                flat[256:].view(11, 256), 4, "unaligned, D 256")
    _topk_check(torch, ops, ref, unit(40, 2048), unit(3000, 2048), 5,
                "queries staged, D 2048")
    qs, ds = shard
    _topk_check(torch, ops, ref, qs, ds, 5, "1M-doc shard")
    _topk_check(torch, ops, ref, qs, ds, 32, "1M-doc shard")
    _topk_check(torch, ops, ref, qs[:1], ds, 5, "1M-doc shard")
    _topk_same_twice(torch, ops, qm, dm, km, "main-path")
    _topk_same_twice(torch, ops, qs, ds, 5, "1M-doc")
    what, traced = profiled
    names = [n for n in traced if TOPK_KERNEL.search(n)]
    log(f"  retrieval_topk [profile] {what} ran {len(names)} device "
        f"kernel(s): {names}")
    if ops.retrieval_topk_plan(qm.shape[0], dm.shape[0], sms)[1] == 1:
        check(len(names) == 1, f"main path: {len(names)} device kernels")

    t_k, t_p, t_l, bnd, by = _topk_times(torch, ops, ref, qm, dm, km,
                                         "main path", card)
    _topk_times(torch, ops, ref, qs, ds, 5, "1M-doc shard", card)
    _topk_times(torch, ops, ref, qs[:1], ds, 5, "1M-doc shard", card)
    one = unit(1, qm.shape[1])
    log(f"  retrieval_topk main path with a warm L2: kernel "
        f"{bench_ms(lambda: ops.retrieval_topk(qm, dm, km), cold=False):.4f}"
        f" ms, topk(q@d.T) "
        f"{bench_ms(lambda: torch.topk(qm @ dm.T, km), cold=False):.4f} ms; "
        f"against one doc (launch, ring, selection) "
        f"{bench_ms(lambda: ops.retrieval_topk(qm, one, 1)):.4f} ms "
        f"[{card['smi']}]")
    _topk_forced_splits(torch, ops, qm, dm, km, (1, 2), "main path", card)
    _topk_forced_splits(torch, ops, qs, ds, 5, (sms, 2 * sms, 4 * sms),
                        "1M-doc shard", card)
    if TOPK_SWEEP:
        kernel_sweep(torch, ops, "topk", "retrieval_topk", TOPK_VARIANTS,
                     ops.retrieval_topk, {"main path": (qm, dm, km),
                                          "1M Nq32": (qs, ds, 5),
                                          "1M Nq1": (qs[:1], ds, 5)}, card)
    rec["retrieval_topk"] = dict(
        max_abs_err=err_main, ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_l)


def _ids_agree(torch, s_plain, i, i_plain, tol) -> bool:
    """Ids equal, or differing only where the plain scores tie within
    tolerance (another summation order may swap a near-tie).  The plain
    rows are sorted best first, so a slot's nearest other score is a
    neighbour's."""
    same = i == i_plain
    if bool(same.all()):
        return True
    close = (s_plain[:, 1:] - s_plain[:, :-1]).abs() <= 2 * tol
    near = torch.zeros_like(same)
    near[:, 1:] |= close
    near[:, :-1] |= close
    return bool((same | near).all())


def _ivf_check(torch, ops, ref, q, emb, ids, probe, k, name, tol=1e-5,
               plan=None, plain_probe=None):
    """The kernel (at the rule's plan, or at ``plan`` = (group blocks,
    splits, rows per split)) against the plain version, run on
    ``plain_probe`` when given (a probe id outside the lists is an empty
    list to the kernel; the plain version is given an empty list's)."""
    if plan is None:
        s, i = ops.ivf_retrieval_topk(q, emb, ids, probe, k)
    else:
        s, i = ops._ivf_launch(q, emb, ids, probe, k, *plan)
    s2, i2 = ref.ivf_topk_ref(q, emb, ids, probe if plain_probe is None
                              else plain_probe, k)
    torch.cuda.synchronize()
    err = max_err(s, s2)
    log(f"  ivf_retrieval_topk [{name}] Nq{q.shape[0]} lists "
        f"{tuple(ids.shape)} D{q.shape[1]} nprobe{probe.shape[1]} k{k} "
        f"plan {plan or 'rule'}: scores max|err| {err:.3e} (tol {tol:g}), "
        f"ids equal {int((i == i2).sum())}/{i.numel()}")
    check(_ids_agree(torch, s2, i, i2, tol), f"ivf top-k {name}: ids differ")
    check(err <= tol, f"ivf top-k {name}: {err} > {tol}")
    return s, i, err


def _ivf_narrow_plan(q, ids, probe):
    """csrc/ivf_topk.cu's plan (ops.ivf_retrieval_topk_plan) for these
    inputs."""
    import torch
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ops.ivf_retrieval_topk_plan(q.shape[0], probe.shape[1],
                                       *ids.shape, sms)


def _ivf_narrow(q, emb, ids, probe, k):
    """csrc/ivf_topk.cu at its plan, whatever the route (k <= 32)."""
    from repro_torch.kernels import ops
    return ops._ivf_launch(q, emb, ids, probe, k,
                           *_ivf_narrow_plan(q, ids, probe))


def _ivf_select_forced(q, emb, ids, probe, k):
    """csrc/ivf_select.cu at its plan, whatever the route."""
    import torch
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk_q, _, *cut = ops.ivf_retrieval_topk_select_plan(
        q.shape[0], probe.shape[1], *ids.shape, k, sms)
    return ops._ivf_select_launch(q, emb, ids, probe, k, chunk_q, *cut)


def _ivf_lists(torch, gen, sizes, L, D):
    """Unit rows, list l live in its first sizes[l] slots, unique ids."""
    n_lists = len(sizes)
    emb = torch.randn(n_lists, L, D, generator=gen, device=DEV)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    ids = torch.full((n_lists, L), -1, dtype=torch.int32, device=DEV)
    nxt = 0
    for l, n in enumerate(sizes):
        ids[l, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        emb[l, n:] = 0.0
        nxt += n
    return emb, ids


def _ivf_main(torch, gen, main):
    """The IVF probe's main-path inputs (q, list_emb, list_ids, probe, k):
    the recorded ones, or 8 questions against 12 lists of a ~130-doc
    shard at nprobe 2, k 3."""
    if main is not None:
        return main[0]
    emb, ids = _ivf_lists(torch, gen, [11] * 12, 16, 256)
    q = torch.randn(8, 256, generator=gen, device=DEV)
    probe = torch.stack([torch.randperm(12, generator=gen, device=DEV)[:2]
                         for _ in range(8)]).to(torch.int32)
    return q / q.norm(dim=1, keepdim=True), emb, ids, probe, 3


def _ivf_library(torch, q, emb, ids, probe, k):
    """Yardsticks: (1) the probed lists gathered per query, then
    torch.topk over an einsum of the gathered rows with padding masked
    (returns the gather, timed apart, and the second step); (2) one dense
    product of the queries with every list row, the rows of lists a query
    does not probe and padding masked, then torch.topk (a list a query
    names twice counts once there)."""
    g, gi = emb[probe.long()], ids[probe.long()]

    def scored():
        s = torch.einsum("qd,qpld->qpl", q, g).masked_fill(gi < 0, -1e30)
        return torch.topk(s.reshape(q.shape[0], -1), k)

    n_lists, L, D = emb.shape
    flat, pad = emb.view(-1, D), (ids < 0).view(1, -1)

    def dense():
        probed = torch.zeros(q.shape[0], n_lists, dtype=torch.bool,
                             device=q.device)
        probed.scatter_(1, probe.long(), True)
        s = (q @ flat.T).masked_fill(
            pad | ~probed.repeat_interleave(L, dim=1), -1e30)
        return torch.topk(s, k)
    return g, scored, dense


def _synth_shard(torch, n_docs, dim, n_queries, n_clusters=24, noise=0.25,
                 seed=0):
    """The recipe of benchmarks/retrieval_scale.py::synth_corpus, drawn on
    the card: unit-norm gaussian-mixture docs, queries perturbed from
    random docs."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    centers = torch.randn(n_clusters, dim, generator=gen, device=DEV)
    centers /= centers.norm(dim=1, keepdim=True)
    assign = torch.randint(n_clusters, (n_docs,), generator=gen, device=DEV)
    scale = noise / dim ** 0.5
    docs = centers[assign] + scale * torch.randn(n_docs, dim, generator=gen,
                                                 device=DEV)
    docs /= docs.norm(dim=1, keepdim=True)
    gold = torch.randint(n_docs, (n_queries,), generator=gen, device=DEV)
    queries = docs[gold] + 0.5 * scale * torch.randn(
        n_queries, dim, generator=gen, device=DEV)
    queries /= queries.norm(dim=1, keepdim=True)
    return docs, queries


def _ivf_same_twice(torch, ops, args, label) -> None:
    (s1, i1), (s2, i2) = ops.ivf_retrieval_topk(*args), \
        ops.ivf_retrieval_topk(*args)
    torch.cuda.synchronize()
    check(torch.equal(s1, s2) and torch.equal(i1, i2),
          f"ivf_retrieval_topk {label}: two calls on the same inputs differ")
    log(f"  ivf_retrieval_topk [determinism] two calls on the {label} "
        "inputs are bitwise equal")


def _ivf_cases(torch, ops, ref, gen) -> None:
    """Edge cases: exact ties in and across lists, fewer than k docs and
    an empty list, nprobe 1 with an odd L, k 32; a list probed twice by
    one query; more pairs for a list than a group holds; -1 slots inside
    lists; duplicate rows across lists and a split boundary; k 32 over
    fewer live rows; D 30; probe ids outside the lists; an unaligned
    pointer."""
    # integer rows, exact in any summation order.  List 0 holds the row
    # at slots 0 and 2, list 2 at slot 1; probing [2, 0] ranks list 2's
    # copy first, then list 0's by slot
    row = torch.tensor([1., 0, 2, 0, 1, 0, 0, 1], device=DEV)
    emb = torch.zeros(3, 4, 8, device=DEV)
    ids = torch.tensor([[10, 11, 12, -1], [20, 21, -1, -1],
                        [30, 31, 32, 33]], dtype=torch.int32, device=DEV)
    emb[0, 0] = emb[0, 2] = emb[2, 1] = emb[1, 0] = row
    emb[0, 1] = emb[2, 0] = emb[2, 2] = row * 0.5
    emb[2, 3] = -row
    probe = torch.tensor([[2, 0], [0, 1]], dtype=torch.int32, device=DEV)
    _, i, _ = _ivf_check(torch, ops, ref, torch.stack([row, row]), emb, ids,
                         probe, 6, "ties in and across lists")
    check(i.tolist() == [[31, 10, 12, 30, 32, 11], [10, 12, 20, 11, 21, -1]],
          f"ivf ties: the earlier probe, then the earlier slot must win: {i}")

    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    def probes(rows):
        return torch.tensor(rows, dtype=torch.int32, device=DEV)

    emb, ids = _ivf_lists(torch, gen, [2, 1, 3, 0], 3, 16)
    s, i, _ = _ivf_check(torch, ops, ref, unit(3, 16), emb, ids,
                         probes([[0, 1], [2, 3], [1, 3]]), 6,
                         "fewer than k docs, an empty list")
    check(i[1, 3:].tolist() == [-1] * 3 and i[2, 1:].tolist() == [-1] * 5
          and bool((s[2, 1:] <= -1e29).all()),
          "ivf: slots past the probed docs must be (-1e30, -1)")
    emb, ids = _ivf_lists(torch, gen, [1013, 700, 1013, 5], 1013, 64)
    _ivf_check(torch, ops, ref, unit(5, 64), emb, ids,
               probes([[0], [2], [1], [3], [0]]), 4, "nprobe 1, L 1013")
    pk = probes([[3, 2, 1, 0], [0, 1, 2, 3]] * 2 + [[1, 3, 0, 2]])
    q5 = unit(5, 64)
    _ivf_check(torch, ops, ref, q5, emb, ids, pk, 32, "k 32",
               plan=_ivf_narrow_plan(q5, ids, pk))

    # one list twice in a query's probes: its documents count twice
    emb, ids = _ivf_lists(torch, gen, [7, 5, 6], 8, 16)
    q = torch.cat([2.0 * emb[0, 3:4], unit(2, 16)])
    _, i, _ = _ivf_check(torch, ops, ref, q, emb, ids,
                         probes([[0, 0, 1], [2, 1, 2], [1, 2, 1]]), 8,
                         "a list probed twice")
    check(i[0, :2].tolist() == [3, 3], f"ivf: a list probed twice: {i[0]}")

    # 100 queries all probe list 0 (4 groups, looped by one block or
    # spread over the rule's group blocks), 12 probe list 1 (one group
    # of 12: two warps per 8 pairs), 88 list 2 (a group of 24)
    emb, ids = _ivf_lists(torch, gen, [300, 200, 50, 0], 300, 32)
    q = unit(100, 32)
    probe = probes([[0, 1 if r < 12 else 2] for r in range(100)])
    plan = ops.ivf_retrieval_topk_plan(100, 2, 4, 300, 132)
    s, i, _ = _ivf_check(torch, ops, ref, q, emb, ids, probe, 5,
                         "more pairs than a group", plan=plan)
    s1, i1, _ = _ivf_check(torch, ops, ref, q, emb, ids, probe, 5,
                           "more pairs than a group", plan=(1, 1, 384))
    check(plan[0] > 1 and torch.equal(s, s1) and torch.equal(i, i1),
          f"ivf: plans {plan} and (1, 1, 384) differ")

    # -1 slots inside lists, their rows pointing at the query
    emb, ids = _ivf_lists(torch, gen, [40, 40], 40, 16)
    q = unit(2, 16)
    ids[0, [3, 17, 39]] = -1
    ids[1, [0, 20]] = -1
    emb[0, 3] = emb[0, 17] = emb[0, 39] = 3.0 * q[0]
    emb[1, 0] = emb[1, 20] = 3.0 * q[1]
    s, i, _ = _ivf_check(torch, ops, ref, q, emb, ids,
                         probes([[0, 1], [1, 0]]), 10, "-1 slots inside lists")
    check(bool((s <= 1.0 + 1e-5).all()), "ivf: a -1 slot entered the result")

    # one row at list 0 slots 127, 128 and 256 (across split boundaries
    # when the lists are cut 128 rows a split) and at list 1 slot 5:
    # probing [1, 0] ranks list 1's copy, then list 0's by slot
    emb, ids = _ivf_lists(torch, gen, [401, 300], 401, 32)
    dup = emb[0, 127].clone()
    emb[0, 128] = emb[0, 256] = emb[1, 5] = dup
    q, probe = 2.0 * dup[None], probes([[1, 0]])
    want = [int(ids[1, 5]), 127, 128, 256]
    outs = [_ivf_check(torch, ops, ref, q, emb, ids, probe, 6,
                       "duplicates across lists and splits", plan=plan)
            for plan in (None, (1, 4, 128))]
    for s, i, _ in outs:
        check(i[0, :4].tolist() == want
              and bool((s[0, :4] == s[0, 0]).all()),
              f"ivf duplicates: probe then slot must win: {i[0].tolist()}")
    check(torch.equal(outs[0][0], outs[1][0])
          and torch.equal(outs[0][1], outs[1][1]),
          "ivf duplicates: 1 and 4 splits differ")

    emb, ids = _ivf_lists(torch, gen, [5, 3, 0], 8, 30)
    q2, p2 = unit(2, 30), probes([[0, 1], [1, 2]])
    s, i, _ = _ivf_check(torch, ops, ref, q2, emb, ids, p2, 32,
                         "k 32 over 8 live rows, D 30",
                         plan=_ivf_narrow_plan(q2, ids, p2))
    check(i[0, 8:].eq(-1).all().item() and i[1, 3:].eq(-1).all().item(),
          "ivf k 32: past the live rows must be the fill")
    emb, ids = _ivf_lists(torch, gen, [6, 4, 0], 6, 16)
    _ivf_check(torch, ops, ref, unit(2, 16), emb, ids,
               probes([[0, -1], [3, 1]]), 8, "probe ids outside the lists",
               plain_probe=probes([[0, 2], [2, 1]]))
    flat = unit(1, 3 * 50 * 64 + 1).view(-1)[1:]   # 4 bytes off 16
    emb = flat.view(3, 50, 64)
    ids = torch.arange(150, dtype=torch.int32, device=DEV).view(3, 50)
    _ivf_check(torch, ops, ref, unit(4, 64), emb, ids,
               probes([[0, 2], [1, 0], [2, 1], [0, 1]]), 5,
               "unaligned, D 64")


def _ivf_times(torch, ops, ref, args, plain, label, card, chunks=None):
    """Kernel, plain version and both yardsticks on ``args`` (q, emb, ids,
    probe, k); the gathering yardstick in query ``chunks`` of (q, probe)
    when given.  Returns (kernel, plain, dense yardstick, bound, by)."""
    q, emb, ids, probe, k = args
    t_k = bench_ms(lambda: ops.ivf_retrieval_topk(*args))
    t_p = bench_ms(plain, reps=5 if chunks else 25)
    t_g = t_l = 0.0
    for a, b in chunks or [(q, probe)]:
        t_g += bench_ms(lambda: emb[b.long()], reps=5)
        g, scored, _ = _ivf_library(torch, a, emb, ids, b, k)
        t_l += bench_ms(scored, reps=5)
        del g, scored
    _, _, dense = _ivf_library(torch, q, emb, ids, probe, k)
    t_d = bench_ms(dense)
    d_err = max_err(dense()[0], ops.ivf_retrieval_topk(*args)[0])
    nbytes, flops, traffic, old = ivf_work(q, emb, ids, probe, k)
    bnd, by = bound_ms(nbytes, flops, "float32")
    log(f"  ivf_retrieval_topk {label} Nq{q.shape[0]} lists "
        f"{tuple(ids.shape)} nprobe{probe.shape[1]} k{k}: kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, gather {t_g:.4f} ms + "
        f"topk(einsum) {t_l:.4f} ms, dense topk(q @ lists.T, masked) "
        f"{t_d:.4f} ms (its scores within {d_err:.1e} of the kernel's), "
        f"bound {bnd:.5f} ms ({by}, {nbytes} bytes), "
        f"{100 * bnd / t_k:.1f}% of the bound; the kernel reads {traffic} "
        f"bytes of lists (one read per (query, probe): {old}) "
        f"[{card['smi']}]")
    return t_k, t_p, t_d, bnd, by


def _ivf_shard(torch, ops, ref, card):
    """A realistic shard: 1M docs x 256 f32, an IVFIndex trained on the
    card with the defaults (256 lists, nprobe 51); Nq 32 at k 5 and 32,
    Nq 1 at k 5; the route from k 16 (csrc/ivf_select.cu) at Nq 32 and 1, k
    64 and 6177.  Returns the k 5 cases' kernel inputs by label, and the
    shard's (queries, list_emb, list_ids, probe_ids)."""
    import numpy as np
    from repro_torch.retrieval.ivf import IVFIndex
    docs, qs = _synth_shard(torch, SHARD_DOCS, 256, 32)
    index = IVFIndex(256, device=DEV)
    index.add(docs, range(SHARD_DOCS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.train()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    n_lists, L = index._list_ids.shape
    pad = 1.0 - SHARD_DOCS / (n_lists * L)
    qn = qs.cpu().numpy()
    _, i_search = index.search(qn, 5)
    frac = index.last_scored_frac
    # the routing search() just did, to call the kernel alone
    probe = torch.as_tensor(np.argsort(-(qn @ index._centroids.T), axis=1)
                            [:, :index.nprobe].astype(np.int32), device=DEV)
    el, il = index._list_emb, index._list_ids
    # the plain version and the gathering yardstick gather every probed
    # list per query: run them in query chunks of at most 4 GB of rows
    step = max(1, int(4e9 // (probe.shape[1] * L * 256 * 4)))

    def chunked(q, pr):
        return [(q[a:a + step], pr[a:a + step])
                for a in range(0, q.shape[0], step)]

    def plain_of(q, pr, k):
        def plain():
            outs = [ref.ivf_topk_ref(a, el, il, b, k)
                    for a, b in chunked(q, pr)]
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))
        return plain

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {"Nq32 k5": (qs, probe, 5), "Nq32 k32": (qs, probe, 32),
             "Nq1 k5": (qs[:1], probe[:1], 5)}
    for label, (q, pr, k) in cases.items():
        s, i = _ivf_narrow(q, el, il, pr, k)
        s2, i2 = plain_of(q, pr, k)()
        torch.cuda.synchronize()
        err = max_err(s, s2)
        plan = ops.ivf_retrieval_topk_plan(q.shape[0], pr.shape[1],
                                           n_lists, L, sms)
        log(f"  ivf_retrieval_topk [1M-doc shard {label}] plan {plan} "
            f"({ivf_blocks(il, pr, plan)}) scores max|err| {err:.3e} (tol "
            f"1e-05), ids equal {int((i == i2).sum())}/{i.numel()}")
        check(err <= 1e-5 and _ids_agree(torch, s2, i, i2, 1e-5),
              f"ivf 1M shard {label}: kernel and plain version differ ({err})")
        if label == "Nq32 k5":
            check(np.array_equal(i.cpu().numpy(), i_search),
                  "search != kernel")
            i_nq32 = i
    _ivf_same_twice(torch, ops, (qs, el, il, probe, 5), "1M-doc")
    _, exact = ops.retrieval_topk(qs, docs, 5)
    recall = float(np.mean([len(set(a) & set(b)) / 5 for a, b in
                            zip(i_nq32.cpu().tolist(),
                                exact.cpu().tolist())]))
    tag = f"[{card['smi']}]"
    log(f"  ivf_retrieval_topk 1M-doc shard: k-means {t_train:.3f} s "
        f"(10 iterations, {n_lists} lists), L_max {L}, padding "
        f"{100 * pad:.1f}% of list_emb, nprobe {probe.shape[1]}, scored "
        f"{100 * frac:.2f}% of docs, recall@5 vs exact top-k {recall:.3f} "
        f"{tag}")
    for label, (q, pr, k) in cases.items():
        if k != 5:
            continue
        _ivf_times(torch, ops, ref, (q, el, il, pr, k), plain_of(q, pr, k),
                   f"1M-doc shard {label}", card, chunks=chunked(q, pr))
        log(f"  retrieval_topk (exact, every doc) on the same docs Nq"
            f"{q.shape[0]} k{k}: "
            f"{bench_ms(lambda: ops.retrieval_topk(q, docs, k)):.4f} ms {tag}")
        # the lists cut into other split counts: bitwise equal to the
        # rule's, and the time of each
        gb, n_rule, _ = ops.ivf_retrieval_topk_plan(q.shape[0], pr.shape[1],
                                                    n_lists, L, sms)
        s0, i0 = ops.ivf_retrieval_topk(q, el, il, pr, k)
        times = []
        for want in sorted({1, 2, 4, 8, n_rule // 2, n_rule, 2 * n_rule}
                           - {0}):
            per = -(-(-(-L // ops.IVF_TILE)) // want) * ops.IVF_TILE
            plan = (gb, -(-L // per), per)
            s1, i1 = ops._ivf_launch(q, el, il, pr, k, *plan)
            torch.cuda.synchronize()
            check(torch.equal(s1, s0) and torch.equal(i1, i0),
                  f"ivf 1M {label}: plan {plan} differs from the rule's")
            t = bench_ms(lambda: ops._ivf_launch(q, el, il, pr, k, *plan))
            times.append(f"{plan[1]}: {t:.4f} ({ivf_blocks(il, pr, plan)})")
        log(f"  ivf_retrieval_topk 1M-doc shard {label} forced splits "
            f"(bitwise equal to the rule's {n_rule}) ms {'; '.join(times)} "
            f"{tag}")
    # the route from k 16 (csrc/ivf_select.cu) on the same shard: against the
    # plain version, two calls bitwise equal, k 64's first 32 bitwise the
    # narrow kernel's k 32
    before = ops.launches["ivf_retrieval_topk_select"]
    for label, (q, pr) in (("Nq32", (qs, probe)),
                           ("Nq1", (qs[:1], probe[:1]))):
        for k in (64, 6177):
            s, i = ops.ivf_retrieval_topk(q, el, il, pr, k)
            s2, i2 = plain_of(q, pr, k)()
            torch.cuda.synchronize()
            err = max_err(s, s2)
            log(f"  ivf_retrieval_topk_select [1M-doc shard {label} k{k}] "
                f"scores max|err| {err:.3e} (tol 1e-05), ids equal "
                f"{int((i == i2).sum())}/{i.numel()}")
            check(err <= 1e-5 and _ids_agree(torch, s2, i, i2, 1e-5),
                  f"ivf 1M shard {label} k {k}: the select route and the "
                  f"plain version differ ({err})")
    check(ops.launches["ivf_retrieval_topk_select"] == before + 4,
          "IVF k 64 on the 1M shard did not run csrc/ivf_select.cu")
    s64, i64 = ops.ivf_retrieval_topk(qs, el, il, probe, 64)
    s32, i32 = _ivf_narrow(qs, el, il, probe, 32)
    torch.cuda.synchronize()
    check(torch.equal(i64[:, :32], i32) and torch.equal(s64[:, :32], s32),
          "ivf 1M shard: k 64's first 32 differ from the narrow k 32")
    log("  ivf_retrieval_topk_select [1M-doc shard] k 64's first 32 equal "
        "the narrow kernel's k 32 (ids, scores bitwise)")
    _ivf_same_twice(torch, ops, (qs, el, il, probe, 64), "1M-doc k 64")
    nbytes, flops, _, _ = ivf_work(qs, el, il, probe, 64)
    _wide_times(
        torch, "ivf_retrieval_topk_select 1M-doc shard Nq32 k64 (kernel: "
        "csrc/ivf_select.cu; library: dense masked topk)", card,
        lambda: ops.ivf_retrieval_topk(qs, el, il, probe, 64),
        plain_of(qs, probe, 64),
        _ivf_library(torch, qs, el, il, probe, 64)[2], (nbytes, flops),
        reps=10)
    return ({f"1M {label}": (q, el, il, pr, k)
             for label, (q, pr, k) in cases.items() if k == 5},
            (qs, el, il, probe))


def kernels_ivf(torch, ops, ref, gen, main, rec, card, traced):
    """``traced``: names of the device kernels one main-path call ran
    under torch.profiler, or None when no session could trace it.
    Returns the 1M-doc IVF shard's (queries, list_emb, list_ids,
    probe_ids)."""
    qm, em, im, pm, km = main
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ops.ivf_retrieval_topk_plan(qm.shape[0], pm.shape[1],
                                       im.shape[0], im.shape[1], sms)
    log(f"  ivf_retrieval_topk plan (group blocks, splits, rows per "
        f"split): main path {plan}")
    _, _, err_main = _ivf_check(torch, ops, ref, qm, em, im, pm, km,
                                "main path")
    _ivf_same_twice(torch, ops, main, "main-path")
    if traced is None:
        log("  ivf_retrieval_topk [profile] not counted: the --profile "
            "slice pass held this process's profiler session")
    else:
        names = [n for n in traced if IVF_KERNEL.search(n)]
        log(f"  ivf_retrieval_topk [profile] one main-path call ran "
            f"{len(names)} device kernel(s): {names}")
        check(len(names) == 2, f"ivf main path: {len(names)} device kernels")
    _ivf_cases(torch, ops, ref, gen)
    shard, ivf_shard = _ivf_shard(torch, ops, ref, card)
    if IVF_SWEEP:
        kernel_sweep(torch, ops, "ivf_topk", "ivf_retrieval_topk",
                     IVF_VARIANTS, ops.ivf_retrieval_topk,
                     {"main path": main, **shard}, card)

    t_k, t_p, t_d, bnd, by = _ivf_times(
        torch, ops, ref, main, lambda: ref.ivf_topk_ref(*main), "main path",
        card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        ops.ivf_retrieval_topk(*main)
    host = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    log(f"  ivf_retrieval_topk main path: the wrapper's host time "
        f"{host:.1f} us a call (100 calls enqueued) [{card['smi']}]")
    rec["ivf_retrieval_topk"] = dict(
        max_abs_err=err_main, ms=t_k, plain_ms=t_p, bound_ms=bnd,
        bound_by=by, library_ms=t_d)
    return ivf_shard


def _wide_times(torch, label, card, kernel, plain, library, work,
                reps=25):
    """Kernel, plain version and library call of the wide route, beside
    the bound of ``work`` (bytes, flops).  Returns the JSON fields."""
    t_k, t_p, t_l = (bench_ms(f, reps) for f in (kernel, plain, library))
    bnd, by = bound_ms(*work, "float32")
    log(f"  {label}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
        f"{t_l:.4f} ms, bound {bnd:.5f} ms ({by}), "
        f"{100 * bnd / t_k:.2f}% of the bound [{card['smi']}]")
    return dict(ms=t_k, plain_ms=t_p, bound_ms=bnd, bound_by=by,
                library_ms=t_l)


def _list_forced(q, d, k):
    """csrc/topk_list.cu at its plan, whatever the route."""
    import torch
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ops._topk_list_launch(q, d, k, *ops.retrieval_topk_wide_plan(
        q.shape[0], d.shape[0], k, sms))


def _select_forced(q, d, k):
    """csrc/topk_select.cu at its plan, whatever the route."""
    import torch
    from repro_torch.kernels import ops
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk_q, _, n_splits, per, n_sel, sel_per = \
        ops.retrieval_topk_select_plan(q.shape[0], d.shape[0], k, sms)
    return ops._topk_select_launch(q, d, k, chunk_q, n_splits, per, n_sel,
                                   sel_per)


def _topk_ties(i, s, ties, label) -> None:
    """Row 0's first ids are ``ties`` (equal rows), lowest first."""
    n = len(ties)
    check(i[0, :n].tolist() == ties and bool((s[0, :n] == s[0, 0]).all()),
          f"{label}: ties must go to the lowest doc id: {i[0, :n].tolist()}")


def kernels_topk_list(torch, ops, ref, gen, topk_main, shard, rec,
                      card) -> None:
    """The exact top-k above k 32 and its route (ops.topk_route): which
    kernel each shape launches (by the launch counts), on the main-path
    inputs, 3000 docs and the 1M-doc shard.  csrc/topk_list.cu, forced at
    its plan, against the plain version at k 33, 64, 256, above Nd and
    the limit on the main-path inputs and on 3000 docs (several splits and
    groups), on D 30, Nq 1 (spread warps) and an unaligned pointer; exact
    ties across tiles and splits (at the plan and at forced split counts,
    groups 4 and 8 and merge depths); the first 32 of k 64 against the
    narrow kernel's k 32 (ids equal, scores bitwise equal: one fmaf chain
    per pair in both); two calls bitwise equal; times on the main-path
    inputs at k 64 and on the 1M-doc shard at Nq 1 (the route's) and Nq
    32 (forced, group 8 and 4, beside the route's select kernel).  Then
    ``kernels_topk_select``."""
    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    limit = ops.TOPK_LIST_MAX
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qm, dm, _ = topk_main
    nd = dm.shape[0]
    qb, db = unit(33, 256), unit(3000, 256)
    qs, ds = shard
    routes = []
    for q, d, ks in ((qm, dm, (32, 33, 64, 256, limit, limit + 1)),
                     (qb, db, (64, 1024)), (qs, ds, (64,)),
                     (qs[:1], ds, (64, 128, 129))):
        for k in ks:
            before = dict(ops.launches)
            ops.retrieval_topk(q, d, k)
            ran = {n: c - before[n] for n, c in ops.launches.items()
                   if c != before[n]}
            route = ops.topk_route(q.shape[0], d.shape[0], k)
            check(ran == {route: 1}, f"retrieval_topk Nq {q.shape[0]} Nd "
                  f"{d.shape[0]} k {k} launched {ran}, not {route}")
            routes.append(f"Nq {q.shape[0]} Nd {d.shape[0]} k {k} {route}")
    log(f"  retrieval_topk launch counts: {'; '.join(routes)}")
    plan = ops.retrieval_topk_wide_plan
    log(f"  retrieval_topk_list plan (group, groups, splits, docs per "
        f"split): main path k 64 {plan(qm.shape[0], nd, 64, sms)}, 3000 "
        f"docs Nq 33 k 64 {plan(33, 3000, 64, sms)}, 1M docs Nq 32 k 64 "
        f"{plan(32, SHARD_DOCS, 64, sms)}, Nq 1 k 64 "
        f"{plan(1, SHARD_DOCS, 64, sms)}")
    for k in (33, 64, 256, nd + 7, limit):
        _topk_check(torch, ops, ref, qm, dm, k,
                    "retrieval_topk_list forced, main path", fn=_list_forced)
    for k in (33, 64, 256, 1024, 3001, limit):
        _topk_check(torch, ops, ref, qb, db, k,
                    "retrieval_topk_list forced, 3000 docs", fn=_list_forced)
    _topk_check(torch, ops, ref, unit(5, 30), unit(2000, 30), 100,
                "retrieval_topk_list forced, D 30", fn=_list_forced)
    _topk_check(torch, ops, ref, unit(1, 256), db, 64,
                "retrieval_topk_list, Nq 1 (spread)")
    flat = unit(1, 12 * 256 + 1).view(-1)[1:]     # 4 bytes off 16
    _topk_check(torch, ops, ref, flat[:256].view(1, 256),
                flat[256:].view(11, 256), 40, "retrieval_topk_list, unaligned")
    # equal rows across the list kernel's tiles (128 docs) and splits, and
    # across csrc/topk_select.cu's scan splits and select chunks: ids
    # lowest first
    dup = unit(2500, 64)
    ties = [3, 127, 128, 255, 256, 1023, 1024, 2053, 2499]
    for j in ties[1:]:
        dup[j] = dup[3]
    q1 = 2.0 * dup[3:4]
    for k in (40, 2048, limit + 1):
        route = ops.topk_route(1, dup.shape[0], k)
        s, i, _ = _topk_check(torch, ops, ref, q1, dup, k, f"{route}, ties")
        _topk_ties(i, s, ties, f"{route} k {k}")
        s, i, _ = _topk_check(torch, ops, ref, q1, dup, min(k, limit),
                              "retrieval_topk_list forced, ties",
                              fn=_list_forced)
        _topk_ties(i, s, ties, f"retrieval_topk_list forced k {k}")
    # forced: 10 splits of 2 tiles (k 40: one merge level; k 2048, fan-in
    # 2: four), at group 4 and at group 8 (one query: spread warps)
    for k, group in ((40, 4), (2048, 4), (40, 8)):
        s, i = ops._topk_list_launch(q1, dup, k, group, 1, 10,
                                     2 * ops.TOPK_TILE)
        _topk_ties(i, s, ties,
                   f"retrieval_topk_list k {k} group {group}, 10 splits")
    log("  retrieval_topk_list [ties] ids lowest first across tiles, 10 "
        "forced splits, 1 and 4 merge levels, groups 4 and 8")
    for q, d, label in ((qm, dm, "main path"), (qb, db, "3000 docs"),
                        (qs[:1], ds, "1M-doc shard Nq 1")):
        s64, i64 = _list_forced(q, d, 64)
        s32, i32 = ops.retrieval_topk(q, d, 32)
        torch.cuda.synchronize()
        check(torch.equal(i64[:, :32], i32)
              and torch.equal(s64[:, :32], s32),
              f"list {label}: k 64's first 32 differ from the narrow k 32")
        log(f"  retrieval_topk_list [{label}] k 64's first 32 equal the "
            "narrow kernel's k 32 (ids, scores bitwise)")
    _topk_same_twice(torch, ops, qb, db, 257, "3000-doc k 257 (list)",
                     fn=_list_forced)
    _topk_same_twice(torch, ops, qs[:1], ds, 64, "1M-doc Nq 1 k 64")

    _, _, err = _topk_check(torch, ops, ref, qm, dm, 64,
                            "retrieval_topk_list main path")
    rec["retrieval_topk_list"] = dict(max_abs_err=err, **_wide_times(
        torch, f"retrieval_topk_list main path Nq{qm.shape[0]} Nd{nd} k64",
        card, lambda: ops.retrieval_topk(qm, dm, 64),
        lambda: ref.topk_ref(qm, dm, 64),
        lambda: torch.topk(qm @ dm.T, 64), topk_work(qm, dm, 64)))
    _topk_check(torch, ops, ref, qs[:1], ds, 64,
                "retrieval_topk_list, 1M-doc shard Nq 1")
    _topk_check(torch, ops, ref, qs, ds, 64,
                "retrieval_topk_list forced, 1M-doc shard Nq 32",
                fn=_list_forced)
    tag = f"[{card['smi']}]"
    _wide_times(torch, "retrieval_topk_list 1M-doc shard Nq1 k64", card,
                lambda: ops.retrieval_topk(qs[:1], ds, 64),
                lambda: ref.topk_ref(qs[:1], ds, 64),
                lambda: torch.topk(qs[:1] @ ds.T, 64),
                topk_work(qs[:1], ds, 64))
    # Nq 32 k 64: the list kernel at group 8 (its plan) and 4, bitwise
    # equal, beside the route's kernel
    s0, i0 = _list_forced(qs, ds, 64)
    times = []
    for g in (8, 4):
        groups = -(-32 // g)
        forced = (g, groups, *ops.topk_list_splits(groups, SHARD_DOCS, 64,
                                                   sms))
        s, i = ops._topk_list_launch(qs, ds, 64, *forced)
        torch.cuda.synchronize()
        check(torch.equal(s, s0) and torch.equal(i, i0),
              f"list 1M k 64: plan {forced} differs from the rule's")
        t = bench_ms(lambda: ops._topk_list_launch(qs, ds, 64, *forced))
        times.append(f"group {g} {forced}: {t:.4f}")
    t = bench_ms(lambda: ops.retrieval_topk(qs, ds, 64))
    log(f"  retrieval_topk_list 1M-doc shard Nq32 k64 forced ms "
        f"{'; '.join(times)}; the route's "
        f"{ops.topk_route(32, SHARD_DOCS, 64)} {t:.4f} {tag}")


def kernels_topk_select(torch, ops, ref, gen, topk_main, shard, rec,
                        card) -> None:
    """The exact top-k above ops.TOPK_LIST_MAX: csrc/topk_select.cu.
    Against the plain version at k 6177 on the main-path queries over
    8192 docs, on D 30, an unaligned pointer, integer data with wide ties
    at the k-th score (ids and scores exactly equal), equal rows across
    scan splits and select chunks, and on the 1M-doc shard at Nq 32
    (k 6177, 16384, 65536) and Nq 1; k 6177's first 6176 bitwise equal to
    csrc/topk_list.cu's k 6176 and its first 32 to csrc/topk.cu's k 32;
    two calls bitwise equal; the launch counts.  Times of those cases
    beside topk(q @ d.T, k).  (Where it crosses the list kernel:
    ``kernels_topk_grid``.)"""
    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    limit = ops.TOPK_LIST_MAX
    kw = limit + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ops.retrieval_topk_select_plan
    qm = topk_main[0]
    qs, ds = shard
    before = ops.launches["retrieval_topk_select"]

    log(f"  retrieval_topk_select plan (queries a chunk, chunks, scan "
        f"splits, docs per split, select chunks, docs per chunk): 8192 docs"
        f" Nq {qm.shape[0]} {plan(qm.shape[0], 8192, kw, sms)}, 1M docs "
        f"Nq 32 {plan(32, SHARD_DOCS, kw, sms)}, k 65536 "
        f"{plan(32, SHARD_DOCS, 65536, sms)}, Nq 1 "
        f"{plan(1, SHARD_DOCS, kw, sms)}")
    dw = unit(8192, qm.shape[1])
    _, _, err = _topk_check(torch, ops, ref, qm, dw, kw,
                            "retrieval_topk_select, 8192 docs")
    _topk_check(torch, ops, ref, unit(5, 30), unit(8000, 30), kw,
                "retrieval_topk_select, D 30")
    flat = unit(1, 7001 * 256 + 1).view(-1)[1:]   # 4 bytes off 16
    _topk_check(torch, ops, ref, flat[:256].view(1, 256),
                flat[256:].view(7000, 256), kw,
                "retrieval_topk_select, unaligned")
    # integer data: exact scores, wide ties at the k-th across the scan's
    # splits and the select chunks; ids and scores exactly the plain's
    di = torch.randint(-2, 3, (50_000, 64), generator=gen,
                       device=DEV).float()
    qi = torch.randint(-2, 3, (4, 64), generator=gen, device=DEV).float()
    for k in (kw, 20_000):
        s, i = ops.retrieval_topk(qi, di, k)
        s2, i2 = ref.topk_ref(qi, di, k)
        torch.cuda.synchronize()
        check(torch.equal(s, s2) and torch.equal(i, i2),
              f"retrieval_topk_select integer data k {k}: differs from the "
              "plain version")
        at = ((qi @ di.T) == s2[:, -1:]).sum(1).tolist()
        log(f"  retrieval_topk_select [integer data, Nd 50000] k {k} equal "
            f"to the plain version exactly; docs tied at the k-th: {at}")
    # equal rows across scan splits and select chunks: ids lowest first
    _, _, _, per, _, sel_per = plan(1, 20_000, kw, sms)
    dup = unit(20_000, 64)
    ties = sorted({3, per - 1, per, sel_per - 1, sel_per, 19_999})
    for j in ties[1:]:
        dup[j] = dup[3]
    s, i, _ = _topk_check(torch, ops, ref, 2.0 * dup[3:4], dup, kw,
                          "retrieval_topk_select, ties")
    _topk_ties(i, s, ties, f"retrieval_topk_select k {kw} (split {per}, "
               f"select chunk {sel_per} docs)")
    for q, k in ((qs, kw), (qs, 16384), (qs, 65536), (qs[:1], kw)):
        _topk_check(torch, ops, ref, q, ds, k,
                    "retrieval_topk_select, 1M-doc shard")
    for q, d, label in ((qm, dw, "8192 docs"), (qs, ds, "1M-doc shard")):
        sw, iw = ops.retrieval_topk(q, d, kw)
        sl, il = _list_forced(q, d, limit)
        sn, i_n = ops.retrieval_topk(q, d, 32)
        torch.cuda.synchronize()
        check(torch.equal(sw[:, :limit], sl) and torch.equal(iw[:, :limit], il)
              and torch.equal(sw[:, :32], sn) and torch.equal(iw[:, :32], i_n),
              f"select {label}: k {kw}'s first {limit} (or 32) differ from "
              "the list (narrow) kernel's")
        log(f"  retrieval_topk_select [{label}] k {kw}'s first {limit} equal "
            f"the list kernel's k {limit}, its first 32 the narrow k 32 "
            "(ids, scores bitwise)")
    _topk_same_twice(torch, ops, qm, dw, kw, "8192-doc k 6177")
    _topk_same_twice(torch, ops, qs, ds, kw, "1M-doc k 6177")
    check(ops.launches["retrieval_topk_select"] > before,
          f"k {kw} did not run csrc/topk_select.cu")

    rec["retrieval_topk_select"] = dict(max_abs_err=err, **_wide_times(
        torch, f"retrieval_topk_select Nq{qm.shape[0]} Nd8192 k{kw}", card,
        lambda: ops.retrieval_topk(qm, dw, kw),
        lambda: ref.topk_ref(qm, dw, kw),
        lambda: torch.topk(qm @ dw.T, kw), topk_work(qm, dw, kw)))
    for q, k in ((qs, kw), (qs, 16384), (qs, 65536), (qs[:1], kw)):
        _wide_times(torch, f"retrieval_topk_select 1M-doc shard Nq"
                    f"{q.shape[0]} k{k}", card,
                    lambda: ops.retrieval_topk(q, ds, k),
                    lambda: ref.topk_ref(q, ds, k),
                    lambda: torch.topk(q @ ds.T, k), topk_work(q, ds, k))


TOPK_GRID_K = (64, 128, 256, 512, 1024, 2048, 4096, 6176)
TOPK_GRID_NQ = (1, 8, 32)


def kernels_topk_grid(torch, ops, ref, gen, topk_main, shard, card) -> None:
    """Where the exact top-k's two wide kernels cross: csrc/topk_list.cu
    and csrc/topk_select.cu, each forced at its own plan, bitwise checked
    against each other, at k TOPK_GRID_K, Nq TOPK_GRID_NQ and Nd 240 (the
    main path's docs), 8192 and the 1M-doc shard; beside them the routed
    call (ops.topk_route(Nq, Nd, k)) and topk(q @ d.T, min(k, Nd)).  The
    routed call is checked to run the kernel the route names."""
    qs, ds = shard

    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    listed, selected = _list_forced, _select_forced

    tag = f"[{card['smi']}]"
    rows, worst = [], 0.0
    for d in (topk_main[1], unit(8192, ds.shape[1]), ds):
        nd = d.shape[0]
        for nq in TOPK_GRID_NQ:
            q = qs[:nq]
            for k in TOPK_GRID_K:
                (s0, i0), (s1, i1) = listed(q, d, k), selected(q, d, k)
                before = dict(ops.launches)
                ops.retrieval_topk(q, d, k)
                torch.cuda.synchronize()
                route = ops.topk_route(nq, nd, k)
                ran = {n for n, c in ops.launches.items() if c != before[n]}
                check(torch.equal(s0, s1) and torch.equal(i0, i1),
                      f"top-k grid Nq {nq} Nd {nd} k {k}: the list and the "
                      "select kernel differ")
                check(ran == {route}, f"top-k grid Nq {nq} Nd {nd} k {k}: "
                      f"ran {ran}, the route names {route}")
                kl = min(k, nd)
                t = [bench_ms(f, reps=10) for f in (
                    lambda: listed(q, d, k), lambda: selected(q, d, k),
                    lambda: ops.retrieval_topk(q, d, k),
                    lambda: torch.topk(q @ d.T, kl))]
                ratio = t[2] / min(t[0], t[1])
                worst = max(worst, ratio)
                rows.append(dict(Nq=nq, Nd=nd, k=k, list_ms=t[0],
                                 select_ms=t[1], routed_ms=t[2],
                                 route=route, library_ms=t[3]))
                log(f"  top-k grid Nq {nq} Nd {nd} k {k}: list {t[0]:.4f} "
                    f"/ select {t[1]:.4f} (bitwise equal) / routed "
                    f"{t[2]:.4f} ({route}, {ratio:.3f}x the faster) / "
                    f"topk(q@d.T, {kl}) {t[3]:.4f} ms {tag}")
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "topk_grid.json").write_text(json.dumps(
        {"card": card["smi"], "rows": rows}, indent=1))
    log(f"  top-k grid: the routed call is at most {worst:.3f}x the faster "
        f"kernel over {len(rows)} cells {tag}")


def kernels_ivf_select(torch, ops, ref, gen, ivf_main, rec, card) -> None:
    """The IVF probe's route from k 16 (csrc/ivf_select.cu): against the
    plain version at k 33, 64, 257 and a k above the candidates on the
    main-path inputs (at most 2048 candidates a query: one sort of each
    row of S), and at k 33, 300, 2500 and 5000 on lists longer than one
    tile (4500 candidates: the select rounds, gather, sort runs and merge
    levels); IVF padding, -1 slots inside a list, a list probed twice, one
    doc in two lists (tied by probe rank) and probe ids outside the lists;
    the first 32 of k 64 against the narrow kernel's k 32 (ids equal,
    scores bitwise equal); two calls bitwise equal; times at k 64 on the
    main-path inputs."""
    def unit(n, d):
        x = torch.randn(n, d, generator=gen, device=DEV)
        return x / x.norm(dim=1, keepdim=True)

    before = ops.launches["ivf_retrieval_topk_select"]
    q, emb, ids, probe, _ = ivf_main
    cand = probe.shape[1] * ids.shape[1]
    for k in (33, 64, 257, cand + 5):
        _ivf_check(torch, ops, ref, q, emb, ids, probe, k,
                   f"select, main path, k {k}")
    emb2, ids2 = _ivf_lists(torch, gen, [900, 1100, 0, 1500], 1500, 32)
    ids2[1, [4, 600, 1099]] = -1           # -1 slots inside a list
    emb2[3, 5] = emb2[0, 2]                # one doc's row in two lists
    pr = torch.tensor([[3, 1, 0], [0, 0, 2], [1, 3, 3]], dtype=torch.int32,
                      device=DEV)
    q2 = unit(3, 32)
    q2[0] = 2.0 * emb2[0, 2]
    for k in (33, 300, 2500, 5000):
        s, i, _ = _ivf_check(torch, ops, ref, q2, emb2, ids2, pr, k,
                             f"select, 3 tiles a list, a list probed "
                             f"twice, k {k}")
        check(i[0, :2].tolist() == [int(ids2[3, 5]), int(ids2[0, 2])]
              and bool(s[0, 0] == s[0, 1]),
              f"ivf select k {k}: the tie must go to the earlier probe: "
              f"{i[0, :2].tolist()}")
    _ivf_check(torch, ops, ref, unit(2, 32), emb2, ids2,
               torch.tensor([[1, -1], [7, 3]], dtype=torch.int32, device=DEV),
               64, "select, probe ids outside the lists",
               plain_probe=torch.tensor([[1, 2], [2, 3]], dtype=torch.int32,
                                        device=DEV))
    for qa, ea, ia, pa, label in ((q, emb, ids, probe, "main path"),
                                  (q2, emb2, ids2, pr, "4500 candidates")):
        s64, i64 = ops.ivf_retrieval_topk(qa, ea, ia, pa, 64)
        s32, i32 = _ivf_narrow(qa, ea, ia, pa, 32)
        torch.cuda.synchronize()
        check(torch.equal(i64[:, :32], i32) and torch.equal(s64[:, :32], s32),
              f"ivf select {label}: k 64's first 32 differ from the narrow "
              "k 32")
        log(f"  ivf_retrieval_topk_select [{label}] k 64's first 32 equal "
            "the narrow kernel's k 32 (ids, scores bitwise)")
        _ivf_same_twice(torch, ops, (qa, ea, ia, pa, 300), f"{label} k 300")
    check(ops.launches["ivf_retrieval_topk_select"] > before,
          "IVF k >= 16 did not run csrc/ivf_select.cu")
    _, _, err_i = _ivf_check(torch, ops, ref, q, emb, ids, probe, 64,
                             "select main path")
    dense = _ivf_library(torch, q, emb, ids, probe, 64)[2]
    rec["ivf_retrieval_topk_select"] = dict(max_abs_err=err_i, **_wide_times(
        torch, f"ivf_retrieval_topk_select main path Nq{q.shape[0]} lists "
        f"{tuple(ids.shape)} nprobe{probe.shape[1]} k64", card,
        lambda: ops.ivf_retrieval_topk(q, emb, ids, probe, 64),
        lambda: ref.ivf_topk_ref(q, emb, ids, probe, 64), dense,
        ivf_work(q, emb, ids, probe, 64)[:2]))


IVF_GRID_K = (33, 64, 256, 1024, 6177)
IVF_NARROW_K = (3, 5, 16, 32)


def kernels_ivf_grid(torch, ops, ivf_main, ivf_shard, card) -> None:
    """Where the IVF probe's routes stand: the routed call
    (csrc/ivf_select.cu) beside the dense masked topk(q @ lists.T) at k
    IVF_GRID_K, on the main-path inputs and on the 1M-doc IVF shard at Nq
    1 and 32; then csrc/ivf_select.cu forced at k IVF_NARROW_K on the same
    inputs beside csrc/ivf_topk.cu, the narrow route (bitwise equal)."""
    qs, el, il, probe = ivf_shard
    tag = f"[{card['smi']}]"
    cases = (("main path", ivf_main[:4]),
             ("1M shard", (qs[:1], el, il, probe[:1])),
             ("1M shard", (qs, el, il, probe)))
    for label, (q, emb, ids, pr) in cases:
        n_lists, L = ids.shape
        for k in IVF_GRID_K:
            dense = _ivf_library(torch, q, emb, ids, pr,
                                 min(k, n_lists * L))[2]
            t = [bench_ms(lambda: ops.ivf_retrieval_topk(q, emb, ids, pr, k),
                          reps=10),
                 bench_ms(dense, reps=10)]
            log(f"  ivf grid {label} Nq {q.shape[0]} nprobe {pr.shape[1]} "
                f"L {L} k {k}: {ops.ivf_route(k)} {t[0]:.4f} / dense masked "
                f"topk {t[1]:.4f} ms "
                f"({t[1] / t[0]:.2f}x) {tag}")
    # at k <= 32: the narrow kernel (the route's) and the select route
    # forced, bitwise equal
    for label, (q, emb, ids, pr) in cases:
        for k in IVF_NARROW_K:
            s0, i0 = _ivf_narrow(q, emb, ids, pr, k)
            s1, i1 = _ivf_select_forced(q, emb, ids, pr, k)
            torch.cuda.synchronize()
            check(torch.equal(s0, s1) and torch.equal(i0, i1),
                  f"ivf {label} k {k}: the select route forced differs from "
                  "csrc/ivf_topk.cu")
            t = [bench_ms(lambda: _ivf_narrow(q, emb, ids, pr, k)),
                 bench_ms(lambda: _ivf_select_forced(q, emb, ids, pr, k))]
            log(f"  ivf {label} Nq {q.shape[0]} k {k}: csrc/ivf_topk.cu "
                f"{t[0]:.4f} / csrc/ivf_select.cu {t[1]:.4f} ms (bitwise "
                f"equal; the route: {ops.ivf_route(k)}) {tag}")


def phase_kernels(torch, card, captured: dict, rec: dict,
                  traced: list) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)

    def main(name):
        if name not in captured:
            return None
        _, args, kw = captured[name]
        return args, kw

    kernels_paged(torch, F, ops, ref, gen, main("paged_decode_attention"),
                  rec, card)
    kernels_flash(torch, F, ops, ref, gen, main("flash_attention"), rec,
                  card)
    topk_main = _topk_main(torch, gen, main("retrieval_topk"))
    ivf_main = _ivf_main(torch, gen, main("ivf_retrieval_topk"))
    # the exact top-k's 1M-doc shard: 32 queries, SHARD_DOCS docs, D 256
    shard = [x / x.norm(dim=1, keepdim=True) for x in (
        torch.randn(n, 256, generator=gen, device=DEV)
        for n in (32, SHARD_DOCS))]
    # one profiler session per process: after the --profile slice pass a
    # second session traced no kernels on the card, so the top-k count
    # then comes from that pass, whose one FlatIndex search is a main-path
    # call, and the IVF probe (not on the slice path) goes uncounted.
    # Without it the session also traces csrc/topk_list.cu forced on the
    # shard at k 64 (its scan and merge levels), the route's kernel there
    # (csrc/topk_select.cu) and csrc/topk_select.cu at the limit + 1 and
    # at 65536 (its scan, three histogram and pick rounds, gather, sort
    # and merge levels), and the IVF probe's route from k 16
    # (csrc/ivf_select.cu: fill, scan, the select's passes) at k 64 over
    # the shard's docs cut into 256 lists, 51 probed a query.
    n_l = 256
    lists = shard[1][:SHARD_DOCS // n_l * n_l].view(n_l, -1, 256)
    list_ids = torch.arange(lists.shape[0] * lists.shape[1],
                            dtype=torch.int32, device=DEV).view(n_l, -1)
    probe51 = torch.stack([torch.randperm(n_l, generator=gen, device=DEV)
                           [:51] for _ in range(32)]).to(torch.int32)
    if traced:
        profiled = ("the profiled slice pass's main-path call", traced)
    else:
        profiled = ("one main-path call", _device_kernels(
            torch, lambda: (ops.retrieval_topk(*topk_main),
                            ops.ivf_retrieval_topk(*ivf_main),
                            _list_forced(*shard, 64),
                            ops.retrieval_topk(*shard, 64),
                            ops.retrieval_topk(*shard,
                                               ops.TOPK_LIST_MAX + 1),
                            ops.retrieval_topk(*shard, 65536),
                            ops.ivf_retrieval_topk(shard[0], lists, list_ids,
                                                   probe51, 64))))
    del lists, list_ids
    kernels_topk(torch, ops, ref, gen, topk_main, shard, rec, card,
                 profiled)
    ivf_shard = kernels_ivf(torch, ops, ref, gen, ivf_main, rec, card,
                            None if traced else profiled[1])
    kernels_topk_list(torch, ops, ref, gen, topk_main, shard, rec, card)
    kernels_topk_select(torch, ops, ref, gen, topk_main, shard, rec, card)
    kernels_topk_grid(torch, ops, ref, gen, topk_main, shard, card)
    kernels_ivf_select(torch, ops, ref, gen, ivf_main, rec, card)
    kernels_ivf_grid(torch, ops, ivf_main, ivf_shard, card)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def phase_parity(torch) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    docs, tok, enc, qs = _rag_setup(6)
    cfg = get_smoke_config("olmo-1b", vocab=len(tok))
    params_cpu = Model(cfg).init_params(seed=0, device="cpu")
    params_gpu = _to_device(params_cpu, "cuda")
    answers = {}
    for dev, params in (("cuda", params_gpu), ("cpu", params_cpu)):
        rag, _ = _rag(cfg, params, docs, tok, enc, dev, max_len=128,
                      chunk=8, block=8, batch=2, top_k=2, new_tokens=8)
        res = rag.answer(qs)
        answers[dev] = [r.answer for r in res]
        log(f"parity[{dev}]: prefix hits {rag.last_stats.prefix_hits}, "
            f"refills {rag.last_stats.refills}")
    check(answers["cuda"] == answers["cpu"],
          f"card and CPU answers differ:\n{answers}")
    log(f"parity: {len(qs)} smoke-config answers equal on card and CPU")

    xlstm_parity(torch)

    # the two-node federated IVF cluster with semantic caches: two olmo-1b
    # nodes, and the quickstart's olmo-1b + xlstm-350m
    tok, shards, slots = _cluster_setup(8)
    for archs in (("olmo-1b", "olmo-1b"), CLUSTER_ARCHS):
        cfgs = [get_smoke_config(a, vocab=len(tok)) for a in archs]
        params_cpu = [Model(cfg).init_params(seed=n, device="cpu")
                      for n, cfg in enumerate(cfgs)]
        served = {}
        for dev in ("cuda", "cpu"):
            params = [_to_device(p, dev) for p in params_cpu]
            nodes, fed = _cluster(cfgs, params, tok, shards, dev,
                                  batch_size=2, max_len=192,
                                  prefill_chunk=8, block_size=8, top_k=2,
                                  max_new_tokens=6)
            served[dev], _ = _serve_slots(nodes, slots, 1e9)
            log(f"parity[{dev}]: {'+'.join(archs)} cluster cache hits "
                f"{[nd.stats.cache_hits for nd in nodes]}, prefix hits "
                f"{[nd.stats.prefix_hits for nd in nodes]}, remote contexts "
                f"{fed.stats.remote_contexts}")
            check(all(nd.stats.prefix_hits >= 1 for nd in nodes),
                  f"parity[{dev}]: a {'+'.join(archs)} node had no "
                  "prefix hit")
        check(served["cuda"] == served["cpu"],
              f"card and CPU {'+'.join(archs)} cluster answers, contexts "
              f"or sources differ:\n{served}")
        log(f"parity: {sum(len(o[0]) for o in served['cpu'])} "
            f"{'+'.join(archs)} cluster answers, contexts and sources "
            "equal on card and CPU")


# card-vs-CPU tolerances of the xlstm smoke model (f32): the CPU tests'
# against the reference (the same f32 math summed in another order)
XLSTM_LOGIT_TOL = 1e-4
XLSTM_STATE_TOL = dict(atol=1e-5, rtol=1e-4)


def _xlstm_run(torch, cfg, params, dev):
    """The xlstm smoke model on ``dev``: full-forward logits, then a
    two-row paged run (row 0 left-padded by 5 in its first chunk):
    chunk logits and the recurrent state after the first chunk, and four
    decode steps of seeded tokens (row 1 frozen after two; its state
    steps all the same).  Returns the named tensors on
    the CPU."""
    import numpy as np
    from repro_torch.models import Model
    model = Model(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(5, cfg.vocab_size, (2, 24)).astype(np.int64)
    pos = np.broadcast_to(np.arange(24), (2, 24)).copy()
    T = lambda a: torch.as_tensor(a, device=dev)
    out = {"forward": model.forward(params, T(toks), T(pos))}
    C, frame, first = 8, 24, np.asarray([5, 0], np.int32)
    cache = model.init_paged_cache(2, 48, 8, 12, dev)
    cache.first = T(first)
    cache.block_tables = T(np.arange(12, dtype=np.int32).reshape(2, 6))
    for j in range(frame // C):
        length = np.full(2, j * C, np.int32)
        abs_pos = length[:, None] + np.arange(C)[None]
        p = np.where(abs_pos >= first[:, None], abs_pos - first[:, None], -1)
        out[f"chunk{j}"] = model.prefill_chunk(
            params, T(toks[:, j * C:(j + 1) * C]), T(p.astype(np.int32)),
            cache)
        if j == 0:
            for i, st in cache.state.items():
                for name, a in st.items():
                    out[f"state{i}.{name}"] = a.clone()
    steps = rng.integers(5, cfg.vocab_size, (4, 2, 1)).astype(np.int64)
    for step in range(4):
        active = T(np.asarray([True, step < 2]))
        out[f"decode{step}"] = model.decode_step(params, T(steps[step]),
                                                 cache, active=active)
    return {k: v.float().cpu() for k, v in out.items()}


def xlstm_parity(torch) -> None:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = get_smoke_config("xlstm-350m", num_layers=4)
    params_cpu = Model(cfg).init_params(seed=0, device="cpu")
    got = _xlstm_run(torch, cfg, _to_device(params_cpu, "cuda"), "cuda")
    want = _xlstm_run(torch, cfg, params_cpu, "cpu")
    check(sorted(got) == sorted(want), "xlstm parity: different outputs")
    errs = {}
    for k, w in want.items():
        g = got[k]
        errs[k] = max_err(g, w)
        if k.startswith("state"):
            tol = XLSTM_STATE_TOL
            ok = bool(torch.allclose(g, w, **tol))
        else:
            tol = XLSTM_LOGIT_TOL
            ok = errs[k] <= tol
        check(ok, f"xlstm parity: {k} differs on card and CPU by "
              f"{errs[k]:.3g} (tolerance {tol})")
    worst = lambda pre: max(e for k, e in errs.items() if k.startswith(pre))
    log(f"parity: xlstm-350m smoke ({cfg.num_layers} layers d"
        f"{cfg.d_model}, f32) card vs CPU max |err|: forward "
        f"{worst('forward'):.3g}, chunks {worst('chunk'):.3g}, decode "
        f"{worst('decode'):.3g} (tolerance {XLSTM_LOGIT_TOL}), state after "
        f"a left-padded chunk {worst('state'):.3g} "
        f"(allclose {XLSTM_STATE_TOL})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ",".join(ALL_PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="trace one more slice pass with torch.profiler: "
                    "device busy share and device time by kernel")
    ap.add_argument("--topk-sweep", action="store_true",
                    help="kernels phase: also time topk.cu rebuilt with "
                    "other ring depths, chunk widths and L2 hints")
    ap.add_argument("--ivf-sweep", action="store_true",
                    help="kernels phase: the same for ivf_topk.cu")
    args = ap.parse_args(argv)
    global TOPK_SWEEP, IVF_SWEEP
    TOPK_SWEEP, IVF_SWEEP = args.topk_sweep, args.ivf_sweep
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in ALL_PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # rec: the kernels' JSON fields; captured: main-path inputs by kernel;
    # traced: device kernels of the --profile slice pass
    rec, captured, launches, traced = {}, {}, {}, []
    try:
        t_all = time.perf_counter()
        card = phase_card(torch)
        steps = {
            "build": phase_build,
            "slice": lambda: phase_slice(torch, card, captured, args.profile,
                                         traced),
            "cluster": lambda: phase_cluster(torch, card, captured),
            "runtime": lambda: phase_runtime(torch, card),
            "launcher": lambda: phase_launcher(torch, card),
            "serve": lambda: phase_serve(torch, card, rec),
            "archs": lambda: phase_archs(torch, card, rec),
            "dense": lambda: phase_dense(torch, card, rec),
            "qwen": lambda: phase_qwen(torch, card, rec),
            "whisper": lambda: phase_whisper(torch, card, rec),
            "train": lambda: phase_train(torch, card, rec),
            "kernels": lambda: phase_kernels(torch, card, captured, rec,
                                             traced),
            "parity": lambda: phase_parity(torch),
            # last: its torch.profiler session can leave later ones empty
            "sim": lambda: phase_sim(torch, card),
        }
        seconds = {}
        for name, step in steps.items():
            if name not in phases:
                continue
            t0 = time.perf_counter()
            # a kernel's launches are its counts over every main path
            for kernel, n in (step() or {}).items():
                launches[kernel] = launches.get(kernel, 0) + n
            seconds[name] = round(time.perf_counter() - t0, 1)
        log(f"chip_smoke: phases {phases} passed in "
            f"{time.perf_counter() - t_all:.1f} s (seconds by phase "
            f"{json.dumps(seconds)})")
    except Exception:   # noqa: BLE001  (report any phase failure, exit 1)
        traceback.print_exc()
        return 1
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches.get(name, 0)}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = rec.get(name, {}).get(key)
        if "shapes" in rec.get(name, {}):
            row["shapes"] = rec[name]["shapes"]
        kernels.append(row)
    log(card["smi"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
