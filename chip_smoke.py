#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build    compile the three CUDA kernels from src/repro_torch/kernels/csrc
           (one nvcc per source, in parallel) and report ptxas' register
           and shared-memory use;
  kernels  hold each kernel against its plain PyTorch version on the card
           over the shapes and dtypes of tests/test_kernels.py (the
           fused kernel's single pass and two-pass route, untouched
           windows zero, two launches bitwise equal), and the bulk and
           load forms of all three kernels (FORM_CASES: the form each
           shape must take, windows longer than one staged index chunk,
           bulk == load bitwise, fused == sddmm then spmm bitwise);
  main     the d15 main path at full size through make_problem /
           DistProblem.fusedmm: Erdos-Renyi m = n = 2^22, 16 nonzeros per
           row, r = 128, float32, on one card (p = 1), all three elision
           cells, each checked against backend="ref"; launch counts,
           median ms per cell, Session-cached == uncached bitwise, the
           bulk form on every kernel of the path, and each kernel's time
           beside its bound, its plain version, a library call and its
           load form (timed in turns: load, bulk, bulk, load) at the main
           path's shapes, its rate with B counted once against the card's
           streaming read rate (a sum over 4 GiB), embedding_bag as
           SpMM's second yardstick, each kernel with bfloat16 operands
           (against its load form, bitwise and timed in turns), fused
           == sddmm then spmm bitwise; then the three kernels'
           bulk forms and FusedMM's load form on a power-law matrix
           (R-MAT, 16 edges a row, permuted, as
           benchmarks/bench_fig8_strong_scaling.py draws it, at scale 21:
           drawing and packing scale 22 on the host takes over 120 s);
  obs      observability, the kernel router and conformance on the card
           (repro_torch.obs, api.activate, repro_torch.analysis), on the
           main phase's problem and pack when that phase ran: (A) the
           main path traced at full size, sddmm, spmm, spmm_t and
           fusedmm in each cell, without and with a Session, untraced
           then traced --reps times: traced == untraced bit for bit, one
           round span a call, its event spans aligned with
           schedule_events and tiling it, the kernels launched inside
           the traced rounds (bulk forms), each cell's traced device ms
           beside the untraced call's ms, the Chrome trace written to
           chiprun_out/TRACE_obs_main.json; (B) drift at p = 8 stacked,
           c = 2, ER 2^OBS_DRIFT_SCALE, every dense op and cell of the
           four families with and without a Session (within [0.99,
           1.01], each round's event words summing to its model) and one
           comm="sparse" cell a family (no model, no drift), device ms,
           GB/s and moves per collective kind from the spans; (C)
           api.activate(problem, its pack): routed ops == the problem's
           results bit for bit and within 2e-3 of the local kernels,
           another pack and backend="ref" not routed, the hook cleared;
           (D) run_conformance over every registry cell on 8 stacked
           ranks (64 x 64, r = 16), every cell passing;
  families the other three families at the main path's width and size
           (--families-scale, 2^22 by default): make_problem with
           algorithm="auto" on one card must choose the reference's
           (s15, "fused", c = 1), timed and checked against
           backend="ref" and d15's "fused" output; then s15, d25 and
           s25 at p = 8, c = 2 stacked on the card, every cell each
           family honours: host seconds to plan, launches and launches
           per kernel form in one counted pass, each cell against
           backend="ref", the bitwise cells against the family's
           sddmm-then-spmm sequence, the collective log against
           schedule_words, median ms per call and the memory peak;
  comm_sparse
           support-pruned communication (comm="sparse", compress="bf16")
           at r = 128, p = 8 stacked on the card.  (A) R-MAT 2^16 (16
           edges a row, seed 7, unpermuted, as sparse.powerlaw_problem
           draws it) on check_comm_sparse.py's grids (d15 c = 2 and 4,
           s15, d25 and s25 c = 2), every op and cell: sparse == dense
           bit for bit, the collective log == the dense log plus the
           delta of the plan's SparseMeta (bf16: half the pruned words),
           bf16 within BF16_TOL of the exact wire, comm="auto" choosing
           "sparse", each plan's SparseMeta printed; (B) R-MAT 2^22
           (--comm-scale) with rows and columns permuted (PERMUTE_SEED,
           as the benchmarks draw it), the family, c and cell
           make_problem(algorithm="auto", comm="auto") chooses and d15
           c = 2 "fused", each under dense, sparse and bf16: host
           seconds to plan (the support sets' share), launches, words,
           median ms, the device split and the memory peak, sparse ==
           dense bit for bit; (C) the same R-MAT unpermuted, "auto"'s
           cell under dense and sparse, the same numbers (3 reps);
  rmat_padding
           the unpermuted R-MAT at 2^(--comm-scale - 2), p = 8 stacked,
           PROBE_CELL's family and c (section B's "auto" choice at
           2^22).  Stacked ranks' packs are padded to the heaviest
           rank's block count with blocks that repeat the last window's
           base; the kernels walk each pack's real blocks only.  Checks
           that every window's run is its own blocks and one fusedmm
           against backend="ref"; prints the packed slots per nonzero,
           the most entries one window's run would hold uncapped and
           holds, the host seconds of the first call and the next's ms;
  stacked  p = 8 ranks, c = 2, stacked on the one card (m = n = 2^16):
           d15's every op and cell against p = 1, overlap == serial and
           "none" == sddmm-then-spmm bitwise, collective log == the
           schedule_words model; then s15, d25 and s25 likewise
           against d15 at p = 1, with d25's overlap == serial;
  faults   recovery on the card at the main configuration with integer
           values (vals 1..4, X and Y -3..3, so every accumulation is
           exact): (a) algorithm="auto" on FAULT_P = 8 stacked ranks,
           sddmm, spmm, spmm_t and fusedmm in each elision of its
           family; (b) each call again through api.ElasticProblem with
           a Session and a scripted TransientFault mid-schedule: bit for
           bit (a), one recovery each, Session.invalidate evicting the
           entries the plan replays; (c) a DeviceLost at rank 7:
           api.degrade re-plans onto the largest feasible p (the old
           problem's device state released first), all four ops ==
           (a) bit for bit, the family and c, the re-plan's host
           seconds, the first recovered call's ms and the memory peak;
           (d) meta_dict -> problem_from_meta on 4 stacked ranks: the
           same family and c, SDDMM == (a), a wrong COO refused; (e)
           check_faults.py's guarantee 3 at 2^(--apps-scale - 2): a 6-step
           train_embedding_distributed on 8 ranks losing rank 7 at the
           step-3 SDDMM == a fault-free run checkpointed at step 3 and
           resumed on the degraded grid (X, Y, losses of steps 3-5, bit
           for bit), the later checkpoint's meta on the new p;
  serving  the serving engine (repro_torch.serving) through its entry
           points: (A) the main configuration with integer data (every
           sum exact), CF factors U, V (-3..3) deployed with
           als.deploy_factors on SERVE_P = 8 stacked ranks ("auto"):
           bench_serving.py's open-loop score traffic (a catalog of 8
           hot patterns of 1024 pairs, bursts 10 ms apart, 1, 8 and 32
           clients a burst, 4 bursts) through the batched engine and
           the solo one (no coalescing, no Session), every score
           against the exact dots and batched == solo bit for bit,
           p50/p99, requests a second, launches and packing seconds a
           tick, the device split of one burst's tick, and no operand
           summed on the host; 8 lookups of widths 16-64 in one tick,
           batched against solo, each against the exact product; a
           DeviceLost at rank 7 in a score tick (8 -> 4 ranks) and one
           at rank 3 in a lookup tick (-> 2), answers exact, then the
           Session re-warmed; the same score traffic at p = 1, and the
           p = 1 deployment's eviction freeing it with the collector
           off; (B) GAT inference at 2^--apps-scale nodes (16
           neighbours + self loops), d = 128, one head, on one card:
           16 clients of 256 nodes a tick, 4 ticks, each client's rows
           bit for bit gat_layer_distributed's and within 2e-3 of its
           plain version, an identical re-deploy a pool hit; float
           lookups of 64 and 46 columns, batched (padded to 128
           columns: the bulk form) == solo (bulk and load) bit for bit;
  dist     one process per visible card, one rank each, over NCCL (the
           torch.distributed backend), at the main path's size
           (--scale).  On one card (world size 1) it runs d15's
           "fused" cell alone, against backend="ref", to show that NCCL
           starts and the path runs.  On more: d15's three cells,
           "auto" and another cell of its family, d25's and s25's
           "auto" cell, each family at the c the cost model picks at p;
           each rank's blocks against the stacked run of the same p on
           card 0 bit for bit, each log against schedule_words and the
           stacked log, the stacked run against backend="ref"; launches per
           rank in one counted pass, ms per call (beside the stacked
           run's), the device split, each collective kind's ms and GB/s
           in a serial pass, and d15's overlap against serial (bitwise
           and timed); after d15's cells, on two cards or more, the obs
           cell: d15 "fused" traced on every rank (drift 1.0, device ms
           per collective kind from its spans), every rank's log
           gathered and the rendezvous simulation drained, then made to
           deadlock by one rank's copy skipping a collective.  A rank that fails, or any still running after
           DIST_TIMEOUT_S, fails the phase, and every rank is stopped.
           With two cards or more each rank also takes one sampled-loss
           step (apps/als.py) on the "auto" problem, and its gradients
           must equal the stacked run's on card 0 bit for bit; then the
           R-MAT 2^--comm-scale problem under dense, sparse and bf16
           wires: "auto"'s cell (every rank's blocks against the stacked
           run bit for bit) and d15 "fused" (sparse == dense bit for
           bit), each with ms, the device split, each collective kind's
           ms and GB/s and the share of communication time pruning
           saves; last the fault cells (integer data): d15 "fused" with
           a scripted TransientFault, retried on the same group, bit for
           bit the fault-free run on every rank; then a DeviceLost at
           rank 3: every process takes part in the degraded group, the
           survivors re-plan onto the largest feasible p and equal the
           stacked run of that p on card 0 and the fault-free p = 4
           result bit for bit, the others leave with api.RankRetired;
           then serving on the group (ServingEngine(group=): rank 0 the
           front end, the others following its tick records): (A) the
           serving phase's cell A (ER 2^--scale, integer data, CF
           factors deployed with group=, "auto" at p) through replay_trace
           at 1, 8 and 32 clients batched and 1 and 8 solo, each score
           exact and equal to the same traffic on the stacked run of p
           on card 0 (tick reports too), p50/p99, requests a second and
           each tick's record bytes, broadcast ms and gather ms; the 8
           lookups in one tick (exact, and the stacked run's exact); a
           DeviceLost at rank 3 in a score tick (p -> 2) and at rank 1
           in a lookup tick (-> 1), the ranks left out following on;
           the traffic again on the degraded group with the Session
           re-warmed; (B) the serving phase's cell B (GAT at
           2^--apps-scale nodes) on the group, the served rows bit for
           bit gat_layer_distributed's on the group and within 2e-3 of
           its plain version; at world size 1 a front end with no
           follower at 2^DIST_SERVE_ONE_SCALE rows, equal to the engine
           without a group bit for bit; last the LM train step on the
           group: at world size 1 one step of llama3.2-1b at full width
           (2 layers) with a group of one against none, bit for bit; on
           more cards llama3.2-1b at full width and depth data-parallel
           (global batch 8 x 512, 3 steps, every rank's parameters equal
           bit for bit after each, the gradient sum's ms and GB/s), step
           0 against one card within 1e-4, then remesh(2, 1) from a
           checkpoint and 3 more steps (step 6), the other ranks retired;
           then, on four cards, tensor parallelism over the mesh's model
           axis: qwen3-4b at full width and depth (4.41e9 parameters,
           70.6 GB of float32 state: no one card holds it) at (data 1,
           model 4) through launch.train.main, seq 512 x batch 8, 4
           steps and a checkpoint of whole leaves, every loss and grad
           norm finite, the replicated leaves equal on every card, step
           ms, tokens a second, each card's peak in the steps and while
           the checkpoint is gathered, the model group's sums' ms and
           GB/s (the card synchronised around each), step 0's loss
           against a forward of the whole model on card 0 within 1e-5
           absolute; llama3.2-1b at (2, 2), 3
           steps, a whole-leaf checkpoint, remesh(2, model_parallel=2)
           and 3 more at (1, 2) (step 6, the others retired); the
           DeepSeek-V2-Lite MoE layer expert-parallel (16 experts a
           card) under dispatch="spmm" against "einsum", every leaf
           within 1e-3, each card's 4 SpMM and 1 SDDMM launches and its
           backward launches' ms, bound, plain and library ms; then, on
           four cards, FSDP over the data axis: (F1) qwen3-4b at (data 4,
           model 1) through launch.train.main --fsdp --remat full (the
           sharded init, its peak held to the shards plus one whole
           leaf), seq 512 x batch 8, 4 steps and a checkpoint, each
           card's init and step peaks, step ms, tokens a second, the
           data group's gathers and reduce-scatters in the last step
           (ms, GB/s), step 0's loss against the whole model's forward on
           card 0 within 1e-5, then 2 steps without remat (their losses
           equal, the peak); (F2) llama3.2-1b's (2, 2) -> (1, 2) remesh
           flow with FSDP and remat against the flow without them, each
           loss within 1e-5, step 0 equal; (F3) the DeepSeek-V2-Lite MoE
           layer with its leaves split over the four cards, one row each,
           dispatch="spmm" against "einsum" within 1e-3, each card's 4
           bulk SpMM and 1 load SDDMM (6 and 1 under remat, its grads
           equal), the backward launches' ms, bound, plain and library;
           with --dist-serve-tp-only, on four cards, serving on the model
           axis (float32, seq_shard_decode, each card a block of cached
           positions): (S1) jamba-v0.1-52b at full size (51.5e9
           parameters, 205.8 GB: no card holds it) at (data 1, model 4)
           through launch.serve.main --model-parallel 4 --batch 4
           --prompt-len 512 --gen 32, 2 batches, its capacity factor
           raised to (E + 0.5) / k so that no token is dropped (a
           4-token decode step and a teacher-forced forward then route
           alike): every generated position's logits against a
           teacher-forced forward of the same tokens on the same cards
           within 5e-3, each card's cache bytes a quarter of the whole
           cache's, then the cache extended to 32,768 slots (8,192 a
           card) and 16 decode steps timed there, the first against the
           served first step within 5e-3; prefill s, decode p50/p99 at
           544 and 32,768 slots, each card's peak after init and
           serving; (S3) its MoE layer expert-parallel (4 experts a
           card, capacity 1.25) at 4 and 2,048 tokens, dispatch="spmm"
           (2 SpMM launches counted) against "einsum" within 2e-4, and
           this card's dispatch and combine packs' kernel against its
           plain version with bound, plain and torch.sparse.mm ms; (S2)
           DeepSeek-V2-Lite at full width, depth cut to 4 layers, the
           same as (S1) (its MLA latents split over positions);
  train    the training path (core/grads.py, apps/): (A) grads.fusedmm
           forward + backward on d15 at the main path's size, each cell:
           launches of the forward and of the backward (the same cell
           plus two SpMM^T), the backward's collective log against each
           dual call's schedule_words and costmodel.words_fusedmm_bwd,
           gradients against backend="ref", a Session bitwise neutral,
           the memory peak with and without one, median ms and the
           device split; (B) train_embedding_distributed, 3 SGD steps on
           the same matrix (vals = |v| + 0.5, algorithm="auto"): the
           family and c it chose, the loss falling, no packing after the
           first step, step 1's gradients against backend="ref", ms per
           step and the device split; (C) one ALS round (cg_iters=10)
           and three GAT training steps (16 neighbours a row + self
           loops) at r = d = 128 on 2^--apps-scale rows (2^20 by
           default): the losses falling, the trainable GAT layer against
           gat_layer_distributed, packing seconds, ms and device split.
  lm       the LM zoo's serving path (repro_torch.models, serving.decode,
           launch.serve) in float32: (C) every registered architecture's
           reduced config on the card against the same weights on the
           CPU, prefill of 2 x 16 and 2 decode steps (HuBERT, an
           encoder, its forward alone), logits within 1e-4; (A)
           llama3.2-1b at full width and depth (1.24e9 parameters,
           random from a seed) through launch.serve.main, 2 batches of 4
           prompts x 16 tokens and 16 generated: prefill s, decode
           p50/p99 ms, tokens a second, the memory peak, every decode
           step against a full forward of the same tokens (teacher
           forcing, 5e-3) and every step against the same model on the
           CPU (1e-3); (B) DeepSeek-V2-Lite at full width (MLA, 64
           experts top-6 and 2 shared) with its depth cut to the dense
           layer and 3 MoE layers, served the same way and held to the
           CPU copy (prefills, the first batch's decode steps); then
           one of its MoE layers at 4 x 512 tokens, dispatch="spmm"
           (the Hopper SpMM, 2 bulk launches counted) against
           dispatch="einsum" within 2e-4, both calls' ms, and the
           dispatch and combine packs' kernel against its plain version
           with its bound, plain and torch.sparse.mm ms.
  train_lm the LM zoo's training path (training/, launch.train, the MoE
           dispatch's backward) in float32: (C) every reduced config, one
           train step on the card against the same weights and batch on
           the CPU, the loss and every gradient leaf within 1e-4; (A)
           llama3.2-1b at full width and depth (1.24e9 parameters, random
           from a seed) through launch.train.main at its defaults (seq
           512, batch 8), 4 steps: step 0's loss within 10% of ln(vocab),
           every loss and grad norm finite, the optimizer's step 4; each
           step's ms, tokens a second and the memory peak; (A2) the same
           at full width with its depth cut to 2 layers: 6 steps straight
           against 3 steps, a checkpoint, main resuming and 3 more, the
           parameters within 1e-6; (B) one DeepSeek-V2-Lite MoE layer at
           full width, 4 x 512 tokens, forward and backward under
           dispatch="spmm" (4 bulk SpMM and 1 SDDMM launches counted)
           against "einsum", every gradient leaf within 1e-3 of its
           largest magnitude, both passes' ms, and the backward's three
           launches (D^T and G^T SpMM, the gate SDDMM) against their plain
           versions with their bounds, plain ms and torch.sparse.mm /
           sampled_addmm ms; (D) that layer as TRAIN_LM_TP_SHARES = 4
           expert-parallel shares run in turn (moe.moe_share, 16
           experts each, what each card of a model axis of 4 runs): the
           shares' sum forward and backward against the whole layer,
           every leaf within 1e-3, 16 bulk SpMM and 4 SDDMM launches
           counted, each share's three backward launches against their
           plain versions with bound, plain and library ms; (E)
           llama3.2-1b at full width, depth cut to 2 layers, through
           launch.train.main: 2 steps with --remat full against 2
           without, the losses and every gradient leaf equal bit for
           bit, each run's memory peak.

Then a ``{"kernels": [...]}`` line, each card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero before the last
line.  ``--scale`` shrinks the main path, the faults phase's (a)-(d),
the dist phase and sections A and B of the train phase (2^scale rows),
``--families-scale`` the families phase, ``--apps-scale`` section C,
the faults phase's (e) and the serving phase's cell B (``--scale`` its
cell A), ``--rmat-scale`` the
power-law timing and ``--comm-scale`` the comm_sparse phase and the
dist phase's R-MAT cells for rehearsals; ``--dist-serving-only`` runs
the dist phase's serving cells alone, ``--dist-train-only`` its train
cells alone, ``--dist-tp-only`` its tensor-parallel cells alone (four
cards), ``--dist-tp-sums-only`` the model group's sum in its two forms
alone (four cards), ``--dist-fsdp-only`` its FSDP cells alone (four
cards), ``--dist-serve-tp-only`` its serving cells on the model axis
alone (four cards; they run only so, and their ``kernels`` line holds
the SpMM row of (S3));
``--phases`` picks phases.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside tensor cores
PHASES = ("build", "kernels", "main", "obs", "families", "comm_sparse",
          "rmat_padding", "stacked", "faults", "serving", "dist", "train",
          "lm", "train_lm")

# tests/test_kernels.py shapes and tolerances
SHAPES = [(128, 128, 64, 4), (256, 128, 128, 8), (512, 384, 128, 8),
          (384, 512, 256, 2), (128, 640, 32, 16)]
TILINGS = [(128, 1), (64, 1), (32, 2), (32, 4)]
# (m, n, r, nonzeros per row, row_tile, nz_block, dtype name, the form the
# spmm and sddmm wrappers must choose (or (sddmm's, spmm's) where they
# differ), the fused kernel's route); the two at r = 128 have windows of
# 8192 entries, 32 staged index chunks each; the last is the width of the
# MoE dispatch's backward at DeepSeek-V2-Lite's d = 2,048 in float32, where
# SDDMM's rows exceed the bulk form's 1,024 bytes
FORM_CASES = [(256, 192, 34, 6, 64, 32, "float32", "load", "two_pass"),
              (256, 192, 36, 6, 64, 32, "bfloat16", "load", "load"),
              (256, 192, 36, 6, 64, 32, "float32", "bulk", "bulk"),
              (512, 4096, 128, 64, 128, 64, "float32", "bulk", "bulk"),
              (512, 4096, 128, 64, 128, 64, "bfloat16", "bulk", "bulk"),
              (256, 192, 2048, 6, 64, 32, "float32", ("load", "bulk"),
               "two_pass")]


def _misaligned(torch, x):
    """``x``'s values at a base 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    esz = x.element_size()
    shift = 4 // esz + (-buf.data_ptr() // esz) % (16 // esz)
    y = buf[shift:shift + x.numel()].view(x.shape)
    y.copy_(x)
    return y


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Checker:
    """Collects one phase's checks; raises on the first failure."""

    def __init__(self, torch):
        self.torch = torch
        self.n = 0

    def close(self, got, want, tol, what, slack=0.0):
        t = self.torch
        got, want = got.float(), want.float()
        if got.shape != want.shape or not bool(t.isfinite(got).all()):
            raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)} or non-finite")
        err = (got - want).abs()
        bad = err > tol + tol * want.abs() + slack
        if bool(bad.any()):
            raise AssertionError(f"{what}: max abs err "
                                 f"{float(err.max()):.3g} beyond tol {tol}")
        self.n += 1
        return float(err.max())

    def equal(self, a, b, what):
        if not self.torch.equal(a, b):
            raise AssertionError(f"{what}: not bitwise equal")
        self.n += 1

    # the same for one tensor or a tuple of them (fusedmm's (out, R))
    def close_all(self, got, want, tol, what):
        if isinstance(got, tuple):
            return max(self.close(g, w, tol, f"{what} [{i}]")
                       for i, (g, w) in enumerate(zip(got, want)))
        return self.close(got, want, tol, what)

    def equal_all(self, a, b, what):
        if not isinstance(a, tuple):
            a, b = (a,), (b,)
        for i, (x, y) in enumerate(zip(a, b)):
            self.equal(x, y, f"{what} [{i}]")


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build_all()
    ptxas = {}
    for name, text in _build.BUILD_LOG.items():
        ptxas[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln or "spill" in ln]
        for ln in text.splitlines():
            log(f"[nvcc {name}] {ln}")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source": seconds, "ptxas": ptxas})


def _pack(sparse, m, n, k, seed, row_tile, nz_block, group=1):
    rows, cols, vals = sparse.erdos_renyi(m, n, k, seed=seed)
    return sparse.pack_row_tiled(rows, cols, vals, (m, n),
                                 row_tile=row_tile, nz_block=nz_block,
                                 group=group, device="cuda")


def phase_kernels(torch):
    from repro_torch.core import sparse
    from repro_torch.kernels.fusedmm import fusedmm_cuda, fusedmm_plain
    from repro_torch.kernels.sddmm import sddmm_cuda, sddmm_plain
    from repro_torch.kernels.spmm import spmm_cuda, spmm_plain
    ck = Checker(torch)
    worst = {"spmm": 0.0, "sddmm": 0.0, "fusedmm": 0.0}

    def args(S):
        return S.tile_base, S.rows_local, S.cols, S.vals

    for (m, n, r, k) in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            S = _pack(sparse, m, n, k, m + r, 128, 64)
            rng = np.random.default_rng(m + r)
            A = torch.from_numpy(rng.standard_normal((m, r))).to("cuda", dt)
            B = torch.from_numpy(rng.standard_normal((n, r))).to("cuda", dt)
            f32 = dt == torch.float32
            tag = f"{m}x{n} r={r} k={k} {dt}"
            got = sddmm_cuda(*args(S), A, B, row_tile=S.row_tile)
            tol = 2e-5 if f32 else 0.12 * np.sqrt(r) / 8
            worst["sddmm"] = max(worst["sddmm"], ck.close(
                got, sddmm_plain(*args(S), A, B, row_tile=S.row_tile), tol,
                f"sddmm {tag}"))
            ck.equal(got, sddmm_cuda(*args(S), A, B, row_tile=S.row_tile),
                     f"sddmm twice {tag}")
            got = spmm_cuda(*args(S), B, row_tile=S.row_tile, m=m)
            tol = 2e-4 if f32 else 0.15
            worst["spmm"] = max(worst["spmm"], ck.close(
                got, spmm_plain(*args(S), B, row_tile=S.row_tile, m=m), tol,
                f"spmm {tag}"))
            ck.equal(got, spmm_cuda(*args(S), B, row_tile=S.row_tile, m=m),
                     f"spmm twice {tag}")
            out, R = fusedmm_cuda(*args(S), A, B, row_tile=S.row_tile, m=m)
            want_out, want_R = fusedmm_plain(*args(S), A, B,
                                             row_tile=S.row_tile, m=m)
            tol = 2e-3 if f32 else 0.5
            worst["fusedmm"] = max(
                worst["fusedmm"],
                ck.close(out, want_out, tol, f"fusedmm out {tag}"),
                ck.close(R, want_R, tol, f"fusedmm R {tag}"))
            out2, R2 = fusedmm_cuda(*args(S), A, B, row_tile=S.row_tile, m=m)
            ck.equal(out, out2, f"fusedmm twice out {tag}")
            ck.equal(R, R2, f"fusedmm twice R {tag}")
    # tiling sweep: both fused forms against the plain version
    for dt in (torch.float32, torch.bfloat16):
        S = _pack(sparse, 256, 192, 6, 17, 64, 32, group=4)
        rng = np.random.default_rng(17)
        A = torch.from_numpy(rng.standard_normal((256, 128))).to("cuda", dt)
        B = torch.from_numpy(rng.standard_normal((192, 128))).to("cuda", dt)
        want_out, want_R = fusedmm_plain(*args(S), A, B, row_tile=64, m=256)
        tol = 2e-3 if dt == torch.float32 else 0.5
        for r_tile, bps in TILINGS:
            out, R = fusedmm_cuda(*args(S), A, B, row_tile=64, m=256,
                                  r_tile=r_tile, blocks_per_step=bps)
            route = "two_pass" if r_tile < 128 else "bulk"
            if fusedmm_cuda.last_form != route or \
                    fusedmm_cuda.last_two_pass != (r_tile < 128):
                raise AssertionError(f"fusedmm r_tile={r_tile} took "
                                     f"{fusedmm_cuda.last_form}, want "
                                     f"{route}")
            tag = f"r_tile={r_tile} bps={bps} {dt}"
            worst["fusedmm"] = max(
                worst["fusedmm"],
                ck.close(out, want_out, tol, f"fusedmm out {tag}"),
                ck.close(R, want_R, tol, f"fusedmm R {tag}"))
            out2, R2 = fusedmm_cuda(*args(S), A, B, row_tile=64, m=256,
                                    r_tile=r_tile, blocks_per_step=bps)
            ck.equal(out, out2, f"fusedmm twice out {tag}")
            ck.equal(R, R2, f"fusedmm twice R {tag}")
            if dt == torch.float32:
                # shared arithmetic: fused == sddmm then spmm, bit for bit
                Rs = sddmm_cuda(*args(S), A, B, row_tile=64)
                ck.equal(R, Rs, f"fusedmm R == sddmm {tag}")
                ck.equal(out, spmm_cuda(S.tile_base, S.rows_local, S.cols,
                                        Rs, B, row_tile=64, m=256),
                         f"fusedmm out == spmm(sddmm) {tag}")
    # both forms of spmm and sddmm, and windows longer than one staged
    # index chunk, against the plain versions
    forms = []
    for (m, n, r, per_row, row_tile, nz_block, dt, form,
         fused) in FORM_CASES:
        dt = getattr(torch, dt)
        S = _pack(sparse, m, n, per_row, m + r, row_tile, nz_block)
        rng = np.random.default_rng(m + r)
        A = torch.from_numpy(rng.standard_normal((m, r))).to("cuda", dt)
        B = torch.from_numpy(rng.standard_normal((n, r))).to("cuda", dt)
        f32 = dt == torch.float32
        tag = f"{m}x{n} r={r} row_tile={row_tile} per_row={per_row} {dt}"
        got = sddmm_cuda(*args(S), A, B, row_tile=row_tile)
        want = sddmm_plain(*args(S), A, B, row_tile=row_tile)
        out = spmm_cuda(*args(S), B, row_tile=row_tile, m=m)
        want_forms = form if isinstance(form, tuple) else (form, form)
        if (sddmm_cuda.last_form, spmm_cuda.last_form) != want_forms:
            raise AssertionError(f"{tag}: forms {sddmm_cuda.last_form}/"
                                 f"{spmm_cuda.last_form}, want "
                                 f"{want_forms}")
        tol = 2e-5 if f32 else 0.12 * np.sqrt(r) / 8
        worst["sddmm"] = max(worst["sddmm"],
                             ck.close(got, want, tol, f"sddmm {tag}"))
        ck.equal(got, sddmm_cuda(*args(S), A, B, row_tile=row_tile),
                 f"sddmm twice {tag}")
        tol = 2e-4 if f32 else 0.15
        worst["spmm"] = max(worst["spmm"], ck.close(
            out, spmm_plain(*args(S), B, row_tile=row_tile, m=m), tol,
            f"spmm {tag}"))
        ck.equal(out, spmm_cuda(*args(S), B, row_tile=row_tile, m=m),
                 f"spmm twice {tag}")
        fo = fusedmm_cuda(*args(S), A, B, row_tile=row_tile, m=m)
        if fusedmm_cuda.last_form != fused:
            raise AssertionError(f"{tag}: fused route "
                                 f"{fusedmm_cuda.last_form}, want {fused}")
        worst["fusedmm"] = max(worst["fusedmm"], ck.close_all(
            fo, fusedmm_plain(*args(S), A, B, row_tile=row_tile, m=m),
            2e-3 if f32 else 0.5, f"fusedmm {tag}"))
        ck.equal_all(fo, fusedmm_cuda(*args(S), A, B, row_tile=row_tile,
                                      m=m), f"fusedmm twice {tag}")
        if f32:
            ck.equal(fo[1], got, f"fusedmm R == sddmm {tag}")
            ck.equal(fo[0], spmm_cuda(S.tile_base, S.rows_local, S.cols,
                                      got, B, row_tile=row_tile, m=m),
                     f"fusedmm out == spmm(sddmm) {tag}")
        if form == "bulk":
            # values at an unaligned base take the load form; A and B stay
            # aligned, so both forms must give the same bits
            pk2 = args(S)[:3] + (_misaligned(torch, S.vals),)
            ck.equal(got, sddmm_cuda(*pk2, A, B, row_tile=row_tile),
                     f"sddmm bulk == load {tag}")
            ck.equal(out, spmm_cuda(*pk2, B, row_tile=row_tile, m=m),
                     f"spmm bulk == load {tag}")
            ck.equal_all(fo, fusedmm_cuda(*pk2, A, B, row_tile=row_tile,
                                          m=m), f"fusedmm bulk == load {tag}")
            if (sddmm_cuda.last_form, spmm_cuda.last_form,
                    fusedmm_cuda.last_form) != ("load",) * 3:
                raise AssertionError(f"{tag}: unaligned vals kept bulk")
        forms.append(f"{'/'.join(want_forms)}/{fused}: {tag}")
    # windows no block touches are exactly zero
    S = sparse.pack_row_tiled(np.array([0, 1, 2], np.int32),
                              np.array([5, 6, 7], np.int32),
                              np.ones(3, np.float32), (512, 128),
                              row_tile=128, nz_block=64, device="cuda")
    Bones = torch.ones((128, 64), device="cuda")
    out = spmm_cuda(*args(S), Bones, row_tile=128, m=512)
    fout, _ = fusedmm_cuda(*args(S), torch.ones((512, 64), device="cuda"),
                           Bones, row_tile=128, m=512)
    for name, o in (("spmm", out), ("fusedmm", fout)):
        if not (bool((o[128:] == 0).all()) and bool((o[3:128] == 0).all())):
            raise AssertionError(f"{name}: untouched windows not zero")
    if not bool((out[:3] == 1).all()):
        raise AssertionError("spmm: touched rows wrong")
    torch.cuda.synchronize()
    emit({"phase": "kernels", "checks": ck.n, "max_abs_err": worst,
          "forms": forms})


def _bound(torch, S, r, m, kind, isz=4):
    """(bound_ms, bound_by, gather_ms, bytes, flops, nnz, bytes_once) of
    one kernel on pack S with dense operands of ``isz`` bytes a value.

    The bound: the bytes of each input read once and each output written
    once (B and A counted as the rows the nonzeros touch) over the HBM
    rate, against the flops over the float32 rate.  ``bytes_once``: what
    the kernel must move on this matrix, where no row of B is reused --
    one row of B per nonzero (B counted once, in the gathers), the
    indices, A's rows and the outputs."""
    live = S.vals != 0
    nnz = int(live.sum())
    slots = S.rows_local.numel()
    idx = slots * 12 + S.tile_base.numel() * 4
    b_rows = int(torch.unique(S.cols[live]).numel())
    a_rows = int(torch.unique(S.rows_global()[live]).numel())
    gathers = nnz * r * isz
    if kind == "spmm":
        nbytes = idx + b_rows * r * isz + m * r * isz
        once = idx + gathers + m * r * isz
        flops = 2 * nnz * r
    elif kind == "sddmm":
        nbytes = idx + (a_rows + b_rows) * r * isz + slots * 4
        once = idx + gathers + a_rows * r * isz + slots * 4
        flops = 2 * nnz * r + nnz
    else:
        nbytes = idx + (a_rows + b_rows) * r * isz + m * r * isz + slots * 4
        once = idx + gathers + a_rows * r * isz + m * r * isz + slots * 4
        flops = 4 * nnz * r + nnz
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    gather = gathers / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", gather, nbytes, flops, nnz, once)


def erdos_renyi_on_card(torch, m, n, per_row, seed):
    """``sparse.erdos_renyi``'s construction (per_row uniform columns per
    row, duplicates dropped, sorted, normal values) drawn by a seeded
    generator on the card; returns host numpy COO for the planner."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.arange(m, device="cuda").repeat_interleave(per_row)
    cols = torch.randint(0, n, (m * per_row,), generator=g, device="cuda")
    key = torch.unique(rows * n + cols)
    vals = torch.randn(key.numel(), generator=g, device="cuda")
    return ((key // n).int().cpu().numpy(), (key % n).int().cpu().numpy(),
            vals.cpu().numpy())


def gat_graph_on_card(torch, m, per_row, seed):
    """``gat.graph_coo``'s construction (the ER pattern plus self loops,
    duplicates dropped, sorted by row) drawn on the card; host rows and
    cols."""
    rows, cols, _ = erdos_renyi_on_card(torch, m, m, per_row, seed)
    loops = torch.arange(m, device="cuda")
    key = torch.unique(torch.cat([
        torch.from_numpy(rows.astype(np.int64)).cuda() * m
        + torch.from_numpy(cols).cuda(), loops * m + loops]))
    return (key // m).int().cpu().numpy(), (key % m).int().cpu().numpy()


def main_pack(prob):
    """The main path's local pack: phase 0, rank (0, 0) of the d15 plan
    (at p = 1 the whole matrix)."""
    from repro_torch.core import sparse
    plan = prob.plan("normal")
    return sparse.RowTiledCOO(plan.rows_local[0][0, 0], plan.cols[0][0, 0],
                              plan.vals[0][0, 0], plan.tile_base[0][0, 0],
                              plan.block_shape, plan.row_tile)


def phase_main(torch, scale: int, reps: int, rmat_scale: int,
               keep: dict | None = None):
    """The main path; with ``keep`` (a dict), its problem, pack and
    operands are left there for the obs phase."""
    from repro_torch.core import api, sparse
    from repro_torch.kernels import ops
    from repro_torch.kernels.fusedmm import fusedmm_cuda, fusedmm_plain
    from repro_torch.kernels.sddmm import sddmm_cuda, sddmm_plain
    from repro_torch.kernels.spmm import spmm_cuda, spmm_plain
    ck = Checker(torch)
    m = n = 1 << scale
    r, per_row, seed = 128, 16, 0
    t0 = time.perf_counter()
    rows, cols, vals = erdos_renyi_on_card(torch, m, n, per_row, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((n, r), generator=g, device="cuda")
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = api.make_problem(rows, cols, vals, (m, n), r, algorithm="d15")
    if prob.grid.device.type != "cuda" or prob.p != 1:
        raise AssertionError("make_problem did not land on one card")
    pack_gib = {}
    for orient in ("normal", "transpose"):
        pl = prob.plan(orient)
        pack_gib[orient] = round(sum(
            t.numel() * t.element_size() for f in (
                pl.rows_local, pl.cols, pl.vals, pl.tile_base)
            for t in f) / 2**30, 3)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    cells = ("none", "reuse", "fused")

    # the main path, counted
    ops.reset_launch_counts()
    outs = {}
    for el in cells:
        out, R = prob.fusedmm(X, Y, elision=el)
        outs[el] = (out, R.raw)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"{name} kernel not launched on the main "
                                 f"path: {launches}")
    # the fused cell runs last, so fusedmm's route is that cell's
    main_forms = {"spmm": spmm_cuda.last_form,
                  "sddmm": sddmm_cuda.last_form,
                  "fusedmm": fusedmm_cuda.last_form}
    if set(main_forms.values()) != {"bulk"}:
        raise AssertionError(f"main path took forms {main_forms}")

    # each cell against the plain kernels, and Session-cached == uncached
    cell_err, cell_ms = {}, {}
    sess = api.Session()
    for el in cells:
        out, raw = outs.pop(el)
        if tuple(out.shape) != (m, r):
            raise AssertionError(f"{el}: out shape {tuple(out.shape)}")
        want, want_R = prob.fusedmm(X, Y, elision=el, backend="ref")
        cell_err[el] = ck.close(out, want, 2e-3, f"main {el} out")
        for t, (a, b) in enumerate(zip(raw, want_R.raw)):
            ck.close(a, b, 2e-3, f"main {el} R phase {t}")
        del want, want_R
        cached, cR = prob.fusedmm(X, Y, elision=el, session=sess)
        ck.equal(out, cached, f"main {el} session out")
        for a, b in zip(raw, cR.raw):
            ck.equal(a, b, f"main {el} session R")
        del out, raw, cached, cR
        cell_ms[el] = time_ms(torch, lambda: prob.fusedmm(X, Y, elision=el),
                              reps)
        torch.cuda.empty_cache()
    emit({"phase": "main", "m": m, "n": n, "r": r, "nnz": prob.nnz,
          "p": prob.p, "c": prob.c, "gen_s": round(t_gen, 3),
          "plan_s": round(t_plan, 3), "pack_gib": pack_gib,
          "launches": launches, "forms": main_forms,
          "cell_ms": cell_ms, "cell_max_abs_err": cell_err,
          "session": sess.stats(), "checks": ck.n,
          "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2)})

    # each kernel at the main path's shapes (phase 0, rank (0, 0))
    S = main_pack(prob)
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    rt = S.row_tile
    crow = torch.zeros(m + 1, dtype=torch.int64, device="cuda")
    r_dev = torch.from_numpy(rows.astype(np.int64)).cuda()
    crow[1:] = torch.cumsum(torch.bincount(r_dev, minlength=m), 0)
    csr = torch.sparse_csr_tensor(
        crow, torch.from_numpy(cols.astype(np.int64)).cuda(),
        torch.from_numpy(vals).cuda(), size=(m, n), check_invariants=False)
    del r_dev
    vals_dev = csr.values()
    Yt = Y.t()
    bag_idx, bag_off = csr.col_indices(), crow[:-1]
    # the same pack with its values at an unaligned base: the load form
    pkl = pk[:3] + (_misaligned(torch, S.vals),)
    Xb, Yb = X.bfloat16(), Y.bfloat16()
    gbps = stream_read_gb_per_s(torch, reps)
    kernels = []
    wrappers = {"spmm": spmm_cuda, "sddmm": sddmm_cuda,
                "fusedmm": fusedmm_cuda}
    # (name, source, TPU kernel, kernel, plain, library call, load form,
    #  kernel, its load form and plain with bfloat16 dense operands (vals
    #  float32), the tolerances in float32 and in bfloat16)
    specs = [
        ("spmm", "src/repro_torch/kernels/csrc/spmm.cu",
         "src/repro/kernels/spmm.py:52",
         lambda: spmm_cuda(*pk, Y, row_tile=rt, m=m),
         lambda: spmm_plain(*pk, Y, row_tile=rt, m=m),
         lambda: torch.sparse.mm(csr, Y),
         lambda: spmm_cuda(*pkl, Y, row_tile=rt, m=m),
         lambda: spmm_cuda(*pk, Yb, row_tile=rt, m=m),
         lambda: spmm_cuda(*pkl, Yb, row_tile=rt, m=m),
         lambda: spmm_plain(*pk, Yb, row_tile=rt, m=m), 2e-3, 0.15),
        ("sddmm", "src/repro_torch/kernels/csrc/sddmm.cu",
         "src/repro/kernels/sddmm.py:49",
         lambda: sddmm_cuda(*pk, X, Y, row_tile=rt),
         lambda: sddmm_plain(*pk, X, Y, row_tile=rt),
         lambda: torch.sparse.sampled_addmm(csr, X, Yt, beta=0.0)
         .values() * vals_dev,
         lambda: sddmm_cuda(*pkl, X, Y, row_tile=rt),
         lambda: sddmm_cuda(*pk, Xb, Yb, row_tile=rt),
         lambda: sddmm_cuda(*pkl, Xb, Yb, row_tile=rt),
         lambda: sddmm_plain(*pk, Xb, Yb, row_tile=rt), 2e-5,
         0.12 * np.sqrt(r) / 8),
        ("fusedmm", "src/repro_torch/kernels/csrc/fusedmm.cu",
         "src/repro/kernels/fusedmm.py:92",
         lambda: fusedmm_cuda(*pk, X, Y, row_tile=rt, m=m),
         lambda: fusedmm_plain(*pk, X, Y, row_tile=rt, m=m),
         None,
         lambda: fusedmm_cuda(*pkl, X, Y, row_tile=rt, m=m),
         lambda: fusedmm_cuda(*pk, Xb, Yb, row_tile=rt, m=m),
         lambda: fusedmm_cuda(*pkl, Xb, Yb, row_tile=rt, m=m),
         lambda: fusedmm_plain(*pk, Xb, Yb, row_tile=rt, m=m), 2e-3, 0.5),
    ]
    for (name, src, repl, kern, plain, lib, load, kb, kbl, plain_b, tol,
         tol_b) in specs:
        wrap = wrappers[name]
        got = kern()
        if wrap.last_form != "bulk":
            raise AssertionError(f"{name}: main shapes took "
                                 f"{wrap.last_form}")
        err = ck.close_all(got, plain(), tol, name)
        # the load form (the first port's design) on the same inputs, in
        # turns with the bulk form: load, bulk, bulk, load
        ck.equal_all(got, load(), f"{name} bulk == load, full size")
        if wrap.last_form != "load":
            raise AssertionError(f"{name}: unaligned vals kept bulk")
        del got
        load_ms = [time_ms(torch, load, reps)]
        ms = statistics.median([time_ms(torch, kern, reps),
                                time_ms(torch, kern, reps)])
        load_ms.append(time_ms(torch, load, reps))
        plain_ms = time_ms(torch, plain, 2)
        lib_ms = time_ms(torch, lib, reps) if lib is not None else None
        bound, by, gather, nbytes, flops, nnz, once = _bound(torch, S, r, m,
                                                             name)
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "matches_plain": True,
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "gather_bound_ms": gather,
            "bytes": nbytes, "flops": flops, "nnz": nnz,
            "bytes_once": once, "tb_per_s": once / ms / 1e9,
            "ceiling_ms": once / gbps / 1e6, "load_form_ms": load_ms,
            "load_form_tb_per_s": once / statistics.median(load_ms) / 1e9}
        if name == "spmm":
            # second yardstick: the same product as a weighted bag sum
            bag = torch.nn.functional.embedding_bag

            def lib2():
                return bag(bag_idx, Y, bag_off, mode="sum",
                           per_sample_weights=vals_dev)
            ck.close(lib2(), spmm_cuda(*pk, Y, row_tile=rt, m=m), 2e-3,
                     "embedding_bag == spmm")
            row["library2"] = "embedding_bag(mode='sum', weights=vals)"
            row["library2_ms"] = time_ms(torch, lib2, reps)
        # bfloat16 dense operands at the same shapes (vals float32): the
        # form the wrapper picks against the load form, bit for bit and
        # timed in turns (load, picked, picked, load)
        got = kb()
        row["bf16_form"] = wrap.last_form
        ck.close_all(got, plain_b(), tol_b, f"{name} bf16")
        ck.equal_all(got, kbl(), f"{name} bf16 {row['bf16_form']} == load, "
                     f"full size")
        if wrap.last_form != "load":
            raise AssertionError(f"{name} bf16: unaligned vals kept bulk")
        del got
        load_ms = [time_ms(torch, kbl, reps)]
        row["bf16_ms"] = statistics.median([time_ms(torch, kb, reps),
                                            time_ms(torch, kb, reps)])
        load_ms.append(time_ms(torch, kbl, reps))
        once = _bound(torch, S, r, m, name, isz=2)[-1]
        row["bf16_bytes_once"] = once
        row["bf16_tb_per_s"] = once / row["bf16_ms"] / 1e9
        row["bf16_load_form_ms"] = load_ms
        row["bf16_load_form_tb_per_s"] = (
            once / statistics.median(load_ms) / 1e9)
        kernels.append(row)
        torch.cuda.empty_cache()
    del Xb, Yb
    # at full size, fused == sddmm then spmm, bit for bit (float32)
    fo, fR = fusedmm_cuda(*pk, X, Y, row_tile=rt, m=m)
    Rs = sddmm_cuda(*pk, X, Y, row_tile=rt)
    ck.equal(fR, Rs, "full size fusedmm R == sddmm")
    ck.equal(fo, spmm_cuda(*pk[:3], Rs, Y, row_tile=rt, m=m),
             "full size fusedmm out == spmm(sddmm)")
    del fo, fR, Rs
    torch.cuda.empty_cache()
    power_law = rmat_times(torch, ck, rmat_scale, r, reps, gbps)
    emit({"phase": "kernel_times", "m": m, "r": r, "nblocks": S.nblocks,
          "nz_block": S.nz_block, "row_tile": rt,
          "stream_read_gb_per_s": gbps, "checks": ck.n,
          "kernels": kernels, "rmat": power_law})
    if keep is not None:
        keep.update(prob=prob, S=S, X=X, Y=Y)
    return kernels


def rmat_times(torch, ck, scale: int, r: int, reps: int, gbps: float):
    """The three kernels' bulk forms, and FusedMM's load form and
    two-pass route, on a power-law matrix: R-MAT 2^scale, 16 edges a row (seed 7), rows and
    columns permuted (seed 1), as benchmarks/bench_fig8_strong_scaling.py
    draws it; the make_problem pack (row_tile = nz_block = 32), float32,
    dense operands drawn on the card (seed 2).  Each kernel is held to
    its plain version; FusedMM's forms are timed in turns."""
    from repro_torch.core import sparse
    from repro_torch.kernels import _build
    from repro_torch.kernels.fusedmm import fusedmm_cuda, fusedmm_plain
    from repro_torch.kernels.sddmm import sddmm_cuda, sddmm_plain
    from repro_torch.kernels.spmm import spmm_cuda, spmm_plain
    m = n = 1 << scale
    t0 = time.perf_counter()
    rows, cols, vals = sparse.rmat(scale, 16, seed=7)
    rows, cols = sparse.random_permute(rows, cols, m, n, seed=1)
    S = sparse.pack_row_tiled(rows, cols, vals, (m, n), row_tile=32,
                              nz_block=32, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    del rows, cols, vals
    g = torch.Generator(device="cuda").manual_seed(2)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((n, r), generator=g, device="cuda")
    pk = (S.tile_base, S.rows_local, S.cols, S.vals)
    pkl = pk[:3] + (_misaligned(torch, S.vals),)
    rt = S.row_tile
    runs = [
        ("spmm", spmm_cuda, lambda p: spmm_cuda(*p, Y, row_tile=rt, m=m),
         lambda: spmm_plain(*pk, Y, row_tile=rt, m=m), 2e-3),
        ("sddmm", sddmm_cuda, lambda p: sddmm_cuda(*p, X, Y, row_tile=rt),
         lambda: sddmm_plain(*pk, X, Y, row_tile=rt), 2e-5),
        ("fusedmm", fusedmm_cuda,
         lambda p: fusedmm_cuda(*p, X, Y, row_tile=rt, m=m),
         lambda: fusedmm_plain(*pk, X, Y, row_tile=rt, m=m), 2e-3),
    ]

    def magnitude(coef):
        # sum over each output element's terms of |coef| * |B|: rows here
        # hold up to ~10^5 nonzeros, and two float32 sums of the same
        # terms in other orders (the kernel's pack order, the plain
        # version's atomics) differ by about 2^-24 of it; 2^-20 of it is
        # added to the tolerance of the scattered outputs
        return spmm_plain(*pk[:3], coef.abs(), Y.abs(), row_tile=rt, m=m)
    out = {}
    for name, wrap, kern, plain, tol in runs:
        got = kern(pk)
        if wrap.last_form != "bulk":
            raise AssertionError(f"rmat {name}: took {wrap.last_form}")
        want = plain()
        if name == "sddmm":
            err = ck.close(got, want, tol, "rmat sddmm")
        elif name == "spmm":
            err = ck.close(got, want, tol, "rmat spmm",
                           slack=2.0**-20 * magnitude(S.vals))
        else:
            err = max(ck.close(got[0], want[0], tol, "rmat fusedmm out",
                               slack=2.0**-20 * magnitude(want[1])),
                      ck.close(got[1], want[1], tol, "rmat fusedmm R"))
            # the same bits as sddmm then spmm, and as the load form
            Rs = sddmm_cuda(*pk, X, Y, row_tile=rt)
            ck.equal(got[1], Rs, "rmat fusedmm R == sddmm")
            ck.equal(got[0], spmm_cuda(*pk[:3], Rs, Y, row_tile=rt, m=m),
                     "rmat fusedmm out == spmm(sddmm)")
            del Rs
        del want
        row = {"max_abs_err": err}
        if name == "fusedmm":
            ck.equal_all(got, kern(pkl), "rmat fusedmm bulk == load")
            if wrap.last_form != "load":
                raise AssertionError("rmat fusedmm: unaligned vals kept "
                                     "bulk")
            load_ms = [time_ms(torch, lambda: kern(pkl), reps)]
            row["ms"] = statistics.median(
                [time_ms(torch, lambda: kern(pk), reps) for _ in range(2)])
            load_ms.append(time_ms(torch, lambda: kern(pkl), reps))
            row["load_form_ms"] = load_ms

            # the two-pass route (sddmm, then spmm with its output)
            def two():
                return fusedmm_cuda(*pk, X, Y, row_tile=rt, m=m,
                                    r_tile=r // 2)
            ck.equal_all(got, two(), "rmat fusedmm bulk == two-pass")
            if wrap.last_form != "two_pass":
                raise AssertionError("rmat fusedmm: r_tile < r kept the "
                                     "single pass")
            row["two_pass_ms"] = time_ms(torch, two, reps)
        else:
            row["ms"] = time_ms(torch, lambda: kern(pk), reps)
        del got
        once = _bound(torch, S, r, m, name)[-1]
        row["bytes_once"] = once
        row["tb_per_s"] = once / row["ms"] / 1e9
        row["ceiling_ms"] = once / gbps / 1e6
        out[name] = row
    # how uneven the windows are: entries per window
    off = _build.window_offsets(S.tile_base, rt, m // rt)
    per_win = (off[1:] - off[:-1]).double() * S.nz_block
    live = per_win[per_win > 0]
    stats = {"scale": scale, "setup_s": setup_s,
             "nnz": int((S.vals != 0).sum()), "nblocks": S.nblocks,
             "windows": m // rt, "empty_windows": int((per_win == 0).sum()),
             "entries_per_window_mean": float(live.mean()),
             "entries_per_window_max": float(live.max()),
             "kernels": out}
    del S, X, Y, pk, pkl
    torch.cuda.empty_cache()
    return stats


def stream_read_gb_per_s(torch, reps: int) -> float:
    """The card's streaming read rate: a plain sum over 4 GiB of float32,
    GB/s (10^9 bytes) by median device time."""
    x = torch.ones(1 << 30, device="cuda")
    ms = time_ms(torch, lambda: x.sum(), reps)
    rate = x.numel() * 4 / ms / 1e6
    del x
    torch.cuda.empty_cache()
    return rate


# the cells each family honours, and those its executors hold bitwise
# equal to the family's sddmm-then-spmm sequence (the rest reassociate)
FAMILY_CELLS = {"s15": ("none", "reuse", "fused"),
                "d25": ("none", "reuse", "fused"),
                "s25": ("none", "reuse")}
FAMILY_BITWISE = {"s15": {"none", "reuse", "fused"},
                  "d25": {"none", "fused"},
                  "s25": {"none", "reuse"}}


def family_sequence(prob, X, Y):
    """The family's unfused two-call sequence on the card: sddmm, then
    the family's spmm executor on the same pack with R's values in its
    value slots (what ``with_values(R.values()).spmm(Y)`` computes,
    without the host round trip).  Returns (out (m, r), R raw)."""
    import dataclasses
    from repro_torch.core import d25, s15, s25
    R = prob.sddmm(X, Y).raw
    g, alg = prob.grid, prob.alg
    plan = dataclasses.replace(prob.plan("normal"), vals=R)
    if alg.name == "s15":
        slabs = s15.spmma_s15(g, plan, alg.shard_y(prob, Y))
        return s15.assemble_spmm_out(g, plan, slabs), R
    if alg.name == "d25":
        return d25.unshard_rows(g, d25.spmma_d25(
            g, plan, d25.skew_b(g, Y))), R
    return s25.unskew_out(g, plan, s25.spmma_s25(
        g, plan, alg.shard_y(prob, Y))), R


def words_match(ck, prob, op, el="none"):
    """The collective log of the last call equals schedule_words."""
    model = [(k, w) for (_, _, k, w) in prob.schedule_words(op, el)
             if k and w]
    logged = [(k, w) for k, w in prob.last_collectives.words() if w]
    if model != logged:
        raise AssertionError(f"{prob.alg.name} {op}/{el}: log {logged} != "
                             f"model {model}")
    ck.n += 1


def device_breakdown(torch, fn):
    """Device ms of one call of ``fn`` from torch.profiler's CUDA
    activity: the port's kernels (names holding spmm, sddmm or fusedmm),
    NCCL's kernels, and every other kernel or copy.  The profiler warms
    up on two calls and records the next (without a warm-up cycle it was
    seen to drop some of a call's kernels); None, the split not measured,
    where it still records another number of the port's launches than
    the wrappers counted in that call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import ops
    fn()
    torch.cuda.synchronize()
    recorded = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=1),
                 on_trace_ready=lambda p: recorded.extend(
                     p.key_averages())) as prof:
        for _ in range(3):
            ops.reset_launch_counts()
            fn()
            torch.cuda.synchronize()
            prof.step()
    counted = sum(ops.launch_counts().values())
    ours = other = nccl = 0.0
    launches = 0
    for ev in recorded:
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if not t:
            continue
        if any(k in ev.key for k in ("spmm", "sddmm", "fusedmm")):
            ours += t
            launches += ev.count
        elif "nccl" in ev.key.lower():
            nccl += t
        else:
            other += t
    if launches != counted:
        log(f"device_breakdown: the profile holds {launches} of the "
            f"{counted} launches the wrappers counted, among "
            f"{[ev.key for ev in recorded][:8]}")
        return None
    return {"kernels_ms": ours / 1e3, "kernel_launches": launches,
            "other_device_ms": other / 1e3, "nccl_ms": nccl / 1e3}


def run_family_cells(torch, ck, prob, X, Y, cells, reps, tag):
    """One counted pass over ``cells`` (launches and forms), then each
    cell against backend="ref", the bitwise cells against the sequence,
    and the median ms per call."""
    from repro_torch.kernels import ops
    name = prob.alg.name
    ops.reset_launch_counts()
    outs = {}
    for el in cells:
        outs[el] = prob.fusedmm(X, Y, elision=el)
        words_match(ck, prob, "fusedmm", el)
    torch.cuda.synchronize()
    launches, forms = ops.launch_counts(), ops.form_counts()
    for k in ("sddmm", "spmm"):
        if launches[k] <= 0:
            raise AssertionError(f"{tag}: {k} kernel not launched: "
                                 f"{launches}")
    err, ms, split = {}, {}, {}
    seq = None
    for el in cells:
        out, R = outs.pop(el)
        if tuple(out.shape) != (prob.m, prob.r):
            raise AssertionError(f"{tag} {el}: out {tuple(out.shape)}")
        want, wR = prob.fusedmm(X, Y, elision=el, backend="ref")
        err[el] = max(ck.close(out, want, 2e-3, f"{tag} {el} out"),
                      ck.close(R.raw, wR.raw, 2e-3, f"{tag} {el} R"))
        del want, wR
        if name in FAMILY_BITWISE and el in FAMILY_BITWISE[name]:
            if seq is None:
                seq = family_sequence(prob, X, Y)
            ck.equal(out, seq[0], f"{tag} {el} == sddmm;spmm out")
            ck.equal(R.raw, seq[1], f"{tag} {el} == sddmm;spmm R")
        del out, R
        ms[el] = time_ms(torch, lambda: prob.fusedmm(X, Y, elision=el),
                         reps)
        split[el] = device_breakdown(
            torch, lambda: prob.fusedmm(X, Y, elision=el))
        torch.cuda.empty_cache()
    return launches, forms, err, ms, split


def phase_families(torch, scale: int, reps: int, full_scale: int):
    """The three other families on the card at the main path's width:
    "auto" at p = 1, then s15, d25 and s25 at p = 8, c = 2 stacked."""
    from repro_torch.core import api
    ck = Checker(torch)
    m = n = 1 << scale
    r, per_row, seed = 128, 16, 0
    dev = torch.device("cuda")
    rows, cols, vals = erdos_renyi_on_card(torch, m, n, per_row, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((n, r), generator=g, device="cuda")
    report = {"phase": "families", "m": m, "n": n, "r": r,
              "nnz": int(len(vals)),
              "cut": None if scale == full_scale else
              f"m = n = 2^{scale}, not 2^{full_scale}: depth only, widths "
              f"unchanged"}

    # "auto" on one card: the reference's choice, s15 "fused", c = 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    auto = api.make_problem(rows, cols, vals, (m, n), r)
    choice = (auto.alg.name, auto.resolve_elision("auto"), auto.c)
    if choice != ("s15", "fused", 1) or auto.p != 1 \
            or auto.grid.device.type != "cuda":
        raise AssertionError(f"auto chose {choice} on p={auto.p}")
    auto.plan("normal")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches, forms, err, ms, split = run_family_cells(
        torch, ck, auto, X, Y, ("fused",), reps, "auto")
    # against the d15 "fused" cell of the main path
    d15p = api.make_problem(rows, cols, vals, (m, n), r, algorithm="d15")
    want, _ = d15p.fusedmm(X, Y, elision="fused")
    got, _ = auto.fusedmm(X, Y)
    err["vs_d15_fused"] = ck.close(got, want, 2e-3, "auto vs d15 fused")
    del d15p, want, got, auto
    torch.cuda.empty_cache()
    report["auto"] = {"choice": list(choice), "plan_s": plan_s,
                      "launches": launches, "forms": forms,
                      "max_abs_err": err, "ms": ms["fused"],
                      "device": split["fused"],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    totals = {k: launches[k] for k in launches}

    for name, cells in FAMILY_CELLS.items():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = api.make_problem(rows, cols, vals, (m, n), r,
                                algorithm=name, c=2, devices=[dev] * 8)
        for orient in (("normal", "transpose") if "reuse" in cells
                       and name == "d25" else ("normal",)):
            prob.plan(orient)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        launches, forms, err, ms, split = run_family_cells(
            torch, ck, prob, X, Y, cells, reps, name)
        for k in launches:
            totals[k] += launches[k]
        report[name] = {"p": prob.p, "c": prob.c, "plan_s": plan_s,
                        "launches": launches, "forms": forms,
                        "max_abs_err": err, "ms": ms, "device": split,
                        "peak_gib": torch.cuda.max_memory_allocated()
                        / 2**30}
        del prob
        torch.cuda.empty_cache()
    report["checks"] = ck.n
    emit(report)
    return totals


def phase_stacked(torch):
    from repro_torch.core import api, d15, sparse
    ck = Checker(torch)
    m = n = 1 << 16
    r = 128
    rows, cols, vals, X, Y = sparse.random_problem(m, n, r, 16, seed=3)
    dev = torch.device("cuda")
    p8 = api.make_problem(rows, cols, vals, (m, n), r, algorithm="d15",
                          c=2, devices=[dev] * 8)
    p1 = api.make_problem(rows, cols, vals, (m, n), r, algorithm="d15",
                          devices=[dev])
    if (p8.p, p8.c, p8.grid.L) != (8, 2, 4):
        raise AssertionError("stacked grid is not 8 ranks, c = 2")

    ck.close(torch.from_numpy(p8.sddmm(X, Y).values()),
             torch.from_numpy(p1.sddmm(X, Y).values()), 2e-4,
             "sddmm p8 vs p1")
    words_match(ck, p8, "sddmm")
    ck.close(p8.spmm(Y), p1.spmm(Y), 2e-4, "spmm p8 vs p1")
    words_match(ck, p8, "spmm")
    ck.close(p8.spmm_t(X), p1.spmm_t(X), 2e-4, "spmm_t p8 vs p1")
    words_match(ck, p8, "spmm_t")
    for el in ("none", "reuse", "fused"):
        o8, R8 = p8.fusedmm(X, Y, elision=el)
        words_match(ck, p8, "fusedmm", el)
        o1, R1 = p1.fusedmm(X, Y, elision=el)
        ck.close(o8, o1, 2e-3, f"fusedmm {el} p8 vs p1")
        ck.close(torch.from_numpy(R8.values()), torch.from_numpy(R1.values()),
                 2e-3, f"fusedmm {el} R p8 vs p1")
    # "none" == the sddmm-then-spmm sequence, bit for bit
    R_seq = p8.sddmm(X, Y)
    out_seq = p8.with_values(R_seq.values()).spmm(Y)
    o_none, R_none = p8.fusedmm(X, Y, elision="none")
    ck.equal(o_none, out_seq, "none == sddmm;spmm out")
    if not np.array_equal(R_none.values(), R_seq.values()):
        raise AssertionError("none == sddmm;spmm R: not bitwise")
    # overlap == serial, bit for bit
    g = p8.grid
    A, B = g.stack(torch.from_numpy(X).cuda()), \
        g.stack(torch.from_numpy(Y).cuda())
    plan, plant = p8.plan("normal"), p8.plan("transpose")
    planb = p8.transposed().plan("transpose")
    pairs = [
        ("sddmm", lambda ov: d15.sddmm_d15(g, plan, A, B, overlap=ov)),
        ("spmma", lambda ov: (d15.spmma_d15(g, plan, B, overlap=ov),)),
        ("spmmb", lambda ov: (d15.spmmb_d15(g, planb, A, overlap=ov),)),
    ]
    # the reuse cell takes Y in the gathered slot and X shifting
    for el, pl, a, b in (("none", plan, A, B), ("reuse", plant, B, A),
                         ("fused", plan, A, B)):
        pairs.append((f"fusedmm/{el}", lambda ov, el=el, pl=pl, a=a, b=b: (
            lambda o: (o[0],) + tuple(o[1]))(
            d15.fusedmm_d15(g, pl, a, b, elision=el, overlap=ov))))
    for what, fn in pairs:
        for a, b in zip(fn(True), fn(False)):
            ck.equal(a, b, f"{what} overlap == serial")
    stacked_families(torch, ck, p1, rows, cols, vals, X, Y)
    torch.cuda.synchronize()
    emit({"phase": "stacked", "m": m, "r": r, "p": 8, "c": 2,
          "families": ["d15"] + list(FAMILY_CELLS), "checks": ck.n})


def stacked_families(torch, ck, p1, rows, cols, vals, X, Y):
    """s15, d25 and s25 at p = 8, c = 2 on the card: every op and cell
    against d15 at p = 1, the collective log against schedule_words, the
    bitwise cells against the sequence, and d25's overlap == serial."""
    from repro_torch.core import api, d25
    from repro_torch.core.collectives import Stacked
    m, n, r = p1.m, p1.n, p1.r
    dev = torch.device("cuda")
    base = {"sddmm": torch.from_numpy(p1.sddmm(X, Y).values()),
            "spmm": p1.spmm(Y), "spmm_t": p1.spmm_t(X)}
    want = p1.fusedmm(X, Y, elision="none")
    want = (want[0], torch.from_numpy(want[1].values()))
    for name, cells in FAMILY_CELLS.items():
        fp = api.make_problem(rows, cols, vals, (m, n), r, algorithm=name,
                              c=2, devices=[dev] * 8)
        ck.close(torch.from_numpy(fp.sddmm(X, Y).values()), base["sddmm"],
                 2e-4, f"{name} sddmm p8 vs d15 p1")
        words_match(ck, fp, "sddmm")
        ck.close(fp.spmm(Y), base["spmm"], 2e-4, f"{name} spmm p8")
        words_match(ck, fp, "spmm")
        ck.close(fp.spmm_t(X), base["spmm_t"], 2e-4, f"{name} spmm_t p8")
        words_match(ck, fp, "spmm_t")
        Xd, Yd = torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()
        seq = family_sequence(fp, Xd, Yd)
        for el in cells:
            o, R = fp.fusedmm(X, Y, elision=el)
            words_match(ck, fp, "fusedmm", el)
            ck.close(o, want[0], 2e-3, f"{name} fusedmm {el} p8")
            ck.close(torch.from_numpy(R.values()), want[1], 2e-3,
                     f"{name} fusedmm {el} R p8")
            if el in FAMILY_BITWISE[name]:
                ck.equal(o, seq[0], f"{name} {el} == sddmm;spmm out")
                ck.equal(R.raw, seq[1], f"{name} {el} == sddmm;spmm R")
        if name != "d25":
            continue
        g, alg = fp.grid, fp.alg
        A, B = alg.shard_x(fp, Xd), d25.skew_b(g, Yd)
        Ay, Bx = alg.shard_x(fp, Yd), d25.skew_b(g, Xd)
        plan, planr = fp.plan("normal"), fp.plan("transpose")
        planb = fp.transposed().plan("transpose")
        runs = [("sddmm", lambda **k: (d25.sddmm_d25(g, plan, A, B, **k),)),
                ("spmm", lambda **k: (d25.spmma_d25(g, plan, B, **k),)),
                ("spmm_t", lambda **k: (d25.spmmb_d25(g, planb, A, **k),))]
        for el, pl, a, b in (("none", plan, A, B), ("reuse", planr, Ay, Bx),
                             ("fused", plan, A, B)):
            runs.append((f"fusedmm/{el}", lambda el=el, pl=pl, a=a, b=b,
                         **k: d25.fusedmm_d25(g, pl, a, b, elision=el,
                                              **k)))
        for what, run in runs:
            outs, logs = [], []
            for ov in (True, False):
                coll = Stacked(g)
                outs.append(run(overlap=ov, coll=coll))
                logs.append(coll.words())
            for a, b in zip(*outs):
                ck.equal(a, b, f"d25 {what} overlap == serial")
            if logs[0] != logs[1]:
                raise AssertionError(f"d25 {what}: overlap log != serial")


# ---------------------------------------------------------------------------
# comm_sparse: support-pruned communication on one card
# ---------------------------------------------------------------------------

#: check_comm_sparse.py's (family, c) grids at p = 8
COMM_SPARSE_GRIDS = [("d15", 2), ("d15", 4), ("s15", 2), ("d25", 2),
                     ("s25", 2)]
ALL_CELLS = {"d15": ("none", "reuse", "fused"), **FAMILY_CELLS}
#: (name, comm, compress) of the three wire formats
WIRES = [("dense", "dense", None), ("sparse", "sparse", None),
         ("bf16", "sparse", "bf16")]
#: compress="bf16" against the exact wire: within this share of the
#: result's largest magnitude (bf16 keeps 8 significant bits)
BF16_TOL = 2e-2
RMAT_SEED = 7
#: the full-size R-MAT's rows and columns are permuted (as
#: benchmarks/bench_fig8_strong_scaling.py draws it): unpermuted, one
#: stacked rank holds about 44% of the nonzeros at p = 8 (rmat_padding)
PERMUTE_SEED = 1
#: (family, c) of the rmat_padding probe: section B's "auto" choice at 2^22
PROBE_CELL = ("s15", 2)


def plan_of(prob, op):
    """The plan an op's executor runs (the api's choice of pack)."""
    two5 = prob.alg.name in ("d15", "d25")
    if op == "spmm_t":
        tp = prob.transposed()
        return tp.plan("transpose") if two5 else tp.plan("normal")
    if op == "fusedmm/reuse" and two5:
        return prob.plan("transpose")
    return prob.plan("normal")


def dense_heights(prob, plan):
    """The dense payload height of each prunable channel of ``plan``."""
    fam, grid = prob.alg.name, prob.grid
    if fam == "d15":
        return {"gather": plan.m // grid.p, "shift": plan.n // grid.p}
    if fam == "d25":
        return {"gather": plan.meta.mA, "shift": plan.meta.nS}
    if fam == "s15":
        return {"gather": plan.m, "gather_b": plan.n}
    return {"shift": plan.mS, "shift_b": plan.nS}


def pruned_words(prob, op):
    """(pruned words, dense words of the same moves) of one op or cell of
    a comm="sparse" problem, from its plan's SparseMeta alone, as
    tests/dist_scripts/check_comm_sparse.py computes its deltas: the
    sparse log is the dense log plus their difference, the "none"
    cell's replay round included.  tests/test_torch_comm_sparse.py
    holds the port's CPU logs to this same model."""
    fam, grid = prob.alg.name, prob.grid
    plan = plan_of(prob, op)
    sm, c, h = plan.smeta, grid.c, dense_heights(prob, plan)
    parts = []                       # (pruned, dense) per pruned channel
    if fam in ("d15", "d25"):
        hops, width = ((grid.L, plan.r) if fam == "d15"
                       else (grid.G, plan.meta.rW))
        rounds = {"spmm_t": [], "fusedmm/none": [hops - 1, hops]}.get(
            op, [hops - 1])             # dense hops of each B round
        if sm.gather and op != "spmm":
            parts.append(((c - 1) * sm.wg * width,
                          (c - 1) * h["gather"] * width))
        if sm.shift:
            parts += [(sum(sm.ws) * width, n_hops * h["shift"] * width)
                      for n_hops in rounds]
    elif fam == "s15":
        rp = plan.r // grid.p
        if sm.gather and op not in ("spmm", "spmm_t"):
            parts.append(((c - 1) * sm.wg * rp, (c - 1) * h["gather"] * rp))
        if sm.gather_b:
            parts += [((c - 1) * sm.wg_b * rp,
                       (c - 1) * h["gather_b"] * rp)] * (
                2 if op == "fusedmm/none" else 1)
    else:
        G, rc = grid.G, plan.rc
        if sm.shift and op not in ("spmm", "spmm_t"):
            parts.append(((G - 1) * sm.ws[0] * rc, (G - 1) * h["shift"] * rc))
        if sm.shift_b:
            parts.append(((G - 1) * sm.ws_b[0] * rc,
                          (G - 1) * h["shift_b"] * rc))
            if op == "fusedmm/none":            # the replay round
                parts.append(((G - 1) * sm.ws_b[0] * rc,
                              G * h["shift_b"] * rc))
    return (float(sum(p for p, _ in parts)),
            float(sum(d for _, d in parts)))


def sparse_meta(prob):
    """Each plan's SparseMeta: which channels ship pruned, and their
    padded widths beside the dense heights."""
    names = [("normal", "normal"), ("spmm_t", "spmm_t")]
    if prob.alg.name in ("d15", "d25"):
        names.insert(1, ("transpose", "fusedmm/reuse"))
    out = {}
    for name, op in names:
        plan = plan_of(prob, op)
        sm = plan.smeta
        out[name] = {"pruned": [k for k in ("gather", "gather_b", "shift",
                                            "shift_b") if getattr(sm, k)],
                     "widths": {"gather": sm.wg, "gather_b": sm.wg_b,
                                "shift": list(sm.ws),
                                "shift_b": list(sm.ws_b)},
                     "dense_heights": dense_heights(prob, plan)}
    return out


def _sparse_ops(fam):
    return ["sddmm", "spmm", "spmm_t"] + [f"fusedmm/{el}"
                                          for el in ALL_CELLS[fam]]


def _run_sparse_op(prob, op, X, Y):
    """The op's results as device tensors (sampled values in host COO
    order)."""
    if op == "sddmm":
        return (prob.sddmm(X, Y).values_tensor(),)
    if op == "spmm":
        return (prob.spmm(Y),)
    if op == "spmm_t":
        return (prob.spmm_t(X),)
    out, R = prob.fusedmm(X, Y, elision=op.split("/")[1])
    return out, R.values_tensor()


def _log_words(prob):
    return sum(w for _, w in prob.last_collectives.words())


def _bf16_err(torch, got, want, what):
    """The largest error of the bf16 wire's results against the exact
    wire's, as a share of each result's largest magnitude; fails past
    BF16_TOL."""
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: bf16 result shape or non-finite")
        share = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        if share > BF16_TOL:
            raise AssertionError(f"{what}: bf16 off by {share:.3g} of the "
                                 f"largest magnitude, beyond {BF16_TOL}")
        worst = max(worst, share)
    return worst


def rmat_on_card(torch, scale: int, edge_factor: int, seed: int,
                 permute_seed=None):
    """``sparse.rmat``'s construction (the same quadrant probabilities,
    one bit of row and column a level, duplicates dropped, sorted, normal
    values) drawn by a seeded generator on the card: the host's numpy
    draw of 2^22 rows took 273 s on the card's machine.  With
    ``permute_seed`` rows and columns are relabelled by seeded random
    permutations (``sparse.random_permute``'s) and the COO sorted again.
    Returns host numpy COO for the planner."""
    a, b, c = 0.57, 0.19, 0.19
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 << scale
    ne = n * edge_factor
    rows = torch.zeros(ne, dtype=torch.int64, device="cuda")
    cols = torch.zeros(ne, dtype=torch.int64, device="cuda")
    for lvl in range(scale):
        u = torch.rand(ne, generator=g, device="cuda", dtype=torch.float64)
        right = u >= a + b
        down = ((u >= a) & (u < a + b)) | (u >= a + b + c)
        rows |= down.long() << lvl
        cols |= right.long() << lvl
    key = torch.unique(rows * n + cols)
    del rows, cols
    vals = torch.randn(key.numel(), generator=g, device="cuda")
    if permute_seed is not None:
        gp = torch.Generator(device="cuda").manual_seed(permute_seed)
        pr = torch.randperm(n, generator=gp, device="cuda")
        pc = torch.randperm(n, generator=gp, device="cuda")
        key, order = torch.sort(pr[key // n] * n + pc[key % n])
        vals = vals[order]
    return ((key // n).int().cpu().numpy(), (key % n).int().cpu().numpy(),
            vals.cpu().numpy())


def rmat_problem(torch, scale, r, seed, permute_seed=None):
    """An R-MAT matrix (edge factor 16): ``sparse.rmat`` on the host for
    an unpermuted one up to 2^16 rows (the CPU tests' generator), else
    :func:`rmat_on_card`; and dense operands drawn on the card.  Returns
    (rows, cols, vals, X, Y, seconds to draw)."""
    from repro_torch.core import sparse
    t0 = time.perf_counter()
    if scale <= 16 and permute_seed is None:
        rows, cols, vals = sparse.rmat(scale, 16, seed=seed)
    else:
        rows, cols, vals = rmat_on_card(torch, scale, 16, seed,
                                        permute_seed)
    gen_s = time.perf_counter() - t0
    log(f"rmat 2^{scale}: {len(vals)} nonzeros drawn in {gen_s:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    m = 1 << scale
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((m, r), generator=g, device="cuda")
    return rows, cols, vals, X, Y, gen_s


def window_runs(torch, tile_base, row_tile, n_windows, live=None):
    """Blocks in each window's run of one rank's pack, as the kernel
    wrappers hand them to the kernels (``live``: the real block count
    they walk; None: every block, as before the cap)."""
    from repro_torch.kernels import _build
    tb = tile_base if live is None else tile_base[:live]
    off = _build.window_offsets(tb, row_tile, n_windows)
    return off[1:] - off[:-1]


def padding_check(torch, ck, scale, r, family, c):
    """The unpermuted R-MAT on the stacked ranks: at p = 8 one rank's
    row block holds a large share of the nonzeros, every rank's pack is
    padded to its block count, and the padding repeats the last window's
    base.  The planners count each pack's real blocks (``plan.nreal``)
    and the wrappers walk only those: checks that every window's run is
    exactly its own blocks (no run longer than its real blocks), and
    that one dense ``fusedmm`` call agrees with backend="ref".  Reports
    the packed slots per nonzero, the most entries one window's run
    would hold uncapped (the padding) and holds capped, and the host
    seconds of the first synchronised call (with every launch of the
    cell) and the device ms of the next."""
    from repro_torch.core import api
    rows, cols, vals, X, Y, _ = rmat_problem(torch, scale, r, RMAT_SEED)
    m = 1 << scale
    prob = api.make_problem(rows, cols, vals, (m, m), r, algorithm=family,
                            c=c, devices=[torch.device("cuda")] * 8)
    plan = prob.plan("normal")
    tbs = plan.tile_base if isinstance(plan.tile_base, tuple) \
        else (plan.tile_base,)
    height = plan.mS if family == "s15" else plan.cmA
    n_windows = height // plan.row_tile
    nreal = np.asarray(plan.nreal).reshape(len(tbs), -1)
    k = prob.nz_block
    slots = sum(t.numel() for t in tbs) * k
    uncapped = capped = 0
    for t, tb in enumerate(tbs):
        flat = tb.reshape(-1, tb.shape[-1])
        for i in range(flat.shape[0]):
            live = int(nreal[t, i])
            runs = window_runs(torch, flat[i], plan.row_tile, n_windows,
                               live)
            own = torch.bincount((flat[i][:live] // plan.row_tile).long(),
                                 minlength=n_windows)
            if not torch.equal(runs, own):
                raise AssertionError(f"padding: rank {i} phase {t}: a "
                                     "window's run is not its own blocks")
            ck.n += 1
            capped = max(capped, int(runs.max()) * k)
            uncapped = max(uncapped, int(window_runs(
                torch, flat[i], plan.row_tile, n_windows).max()) * k)
    t0 = time.perf_counter()
    out, R = prob.fusedmm(X, Y)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    ref, ref_R = prob.fusedmm(X, Y, backend="ref")
    r_vals = R.values_tensor()
    err = ck.close(r_vals, ref_R.values_tensor(), 2e-3, "padding: R vs ref")
    # hub rows sum ~10^5 terms: two float32 orders of one sum differ by
    # about 2^-24 of its terms' magnitudes, as in rmat_times
    mag = prob.spmm(Y.abs(), vals=r_vals.abs(), backend="ref")
    err = max(err, ck.close(out, ref, 2e-3, "padding: fusedmm vs ref",
                            slack=2.0**-20 * mag))
    del out, R, ref, ref_R, r_vals, mag
    ms = time_ms(torch, lambda: prob.fusedmm(X, Y), 1, warmup=0)
    log(f"padding check 2^{scale}: first call {call_s:.2f} s, next "
        f"{ms:.1f} ms")
    return {"m": m, "nnz": int(len(vals)), "family": family, "c": c,
            "slots_per_nonzero": slots / len(vals),
            "last_window_entries_uncapped": uncapped,
            "max_run_entries": capped, "call_s": call_s, "ms": ms,
            "max_abs_err_vs_ref": err}


def comm_sparse_check(torch, ck, scale, r):
    """Section A: every op and cell of check_comm_sparse.py's grids on an
    R-MAT matrix, p = 8 stacked on the card: sparse == dense bit for bit,
    the log == the dense log + the plan's delta (bf16: half the pruned
    words), bf16 within BF16_TOL, comm="auto" -> "sparse"."""
    from repro_torch.core import api
    rows, cols, vals, X, Y, _ = rmat_problem(torch, scale, r, RMAT_SEED)
    m = 1 << scale
    dev = torch.device("cuda")
    report = {"m": m, "nnz": int(len(vals)), "grids": {}}
    t0 = time.perf_counter()
    for fam, c in COMM_SPARSE_GRIDS:
        kw = dict(algorithm=fam, c=c, devices=[dev] * 8)
        auto = api.make_problem(rows, cols, vals, (m, m), r, comm="auto",
                                **kw)
        if auto.comm != "sparse":
            raise AssertionError(f"{fam}: comm='auto' chose {auto.comm}")
        probs = {name: api.make_problem(rows, cols, vals, (m, m), r,
                                        comm=comm, compress=compress, **kw)
                 for name, comm, compress in WIRES}
        row = {"meta": sparse_meta(probs["sparse"]), "words": {},
               "bf16_err": {}}
        for op in _sparse_ops(fam):
            res, words = {}, {}
            for name, prob in probs.items():
                res[name] = _run_sparse_op(prob, op, X, Y)
                words[name] = _log_words(prob)
            what = f"{fam} c={c} {op}"
            ck.equal_all(res["sparse"], res["dense"], f"{what} sparse")
            pruned, dense_w = pruned_words(probs["sparse"], op)
            want = [words["dense"] + pruned - dense_w,
                    words["dense"] + pruned / 2 - dense_w]
            if [words["sparse"], words["bf16"]] != want:
                raise AssertionError(f"{what}: logged {words}, the plan's "
                                     f"delta gives {want}")
            ck.n += 1
            row["words"][op] = [words[name] for name, _, _ in WIRES]
            row["bf16_err"][op] = _bf16_err(torch, res["bf16"],
                                            res["dense"], what)
        report["grids"][f"{fam} c={c}"] = row
        del probs, auto
        torch.cuda.empty_cache()
        log(f"comm_sparse A: {fam} c={c} checked "
            f"({time.perf_counter() - t0:.1f} s in)")
    return report


def comm_sparse_full(torch, ck, scale, r, reps, permuted=True):
    """Section B: R-MAT at full size, p = 8 stacked, the family, c and
    cell "auto" chooses (comm="auto" too) and d15 c = 2 "fused", each
    under the three wires: plan seconds (support sets' share), launches,
    words, ms, device split and memory peak; sparse == dense bit for
    bit.  Section C (``permuted=False``): the unpermuted matrix, "auto"'s
    cell under the dense and sparse wires.  Returns (report, launches of
    the counted calls)."""
    import importlib
    from repro_torch.core import api
    from repro_torch.kernels import ops
    rows, cols, vals, X, Y, gen_s = rmat_problem(
        torch, scale, r, RMAT_SEED, PERMUTE_SEED if permuted else None)
    m = 1 << scale
    dev = torch.device("cuda")
    auto = api.make_problem(rows, cols, vals, (m, m), r, comm="auto",
                            devices=[dev] * 8)
    if auto.comm != "sparse":
        raise AssertionError(f"comm='auto' chose {auto.comm} at scale "
                             f"{scale}")
    cells = [(auto.alg.name, auto.c, auto.resolve_elision("auto"))]
    if permuted:
        cells.append(("d15", 2, "fused"))
    wires = WIRES if permuted else WIRES[:2]
    sec = "B" if permuted else "C"
    del auto
    report = {"m": m, "nnz": int(len(vals)), "rmat_gen_s": gen_s,
              "permuted": permuted, "cells": {}}
    totals = {k: 0 for k in ops.KERNELS}
    for fam, c, el in cells:
        mod = importlib.import_module(f"repro_torch.core.{fam}")
        orient = "transpose" if el == "reuse" and fam in ("d15", "d25") \
            else "normal"
        rows_out, base = {}, None
        for name, comm, compress in wires:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sup_s = []
            t0 = time.perf_counter()
            with patched(mod, "_sparse_sup", seconds_of(sup_s)):
                prob = api.make_problem(rows, cols, vals, (m, m), r,
                                        algorithm=fam, c=c, comm=comm,
                                        compress=compress,
                                        devices=[dev] * 8)
                prob.plan(orient)
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            what = f"{fam} c={c} {el} {name}"
            log(f"comm_sparse {sec}: {what} planned in {plan_s:.1f} s "
                f"(support sets {sum(sup_s):.1f} s)")
            ops.reset_launch_counts()
            out, R = prob.fusedmm(X, Y, elision=el)
            torch.cuda.synchronize()
            launches, forms = ops.launch_counts(), ops.form_counts()
            for k in totals:
                totals[k] += launches[k]
            for k in (("fusedmm",) if (fam, el) == ("d15", "fused")
                      else ("sddmm", "spmm")):
                if launches[k] <= 0:
                    raise AssertionError(f"{what}: {k} kernel not "
                                         f"launched: {launches}")
            words = _log_words(prob)
            got = (out, R.values_tensor())
            if tuple(out.shape) != (m, r):
                raise AssertionError(f"{what}: out {tuple(out.shape)}")
            if base is None:
                base = got
                if not all(bool(torch.isfinite(t).all()) for t in got):
                    raise AssertionError(f"{what}: non-finite")
                err = 0.0
            elif compress is None:
                ck.equal_all(got, base, f"{what} == dense")
                err = 0.0
            else:
                err = _bf16_err(torch, got, base, what)
            del out, R, got
            ms = time_ms(torch, lambda: prob.fusedmm(X, Y, elision=el),
                         reps)
            split = device_breakdown(
                torch, lambda: prob.fusedmm(X, Y, elision=el))
            if split is not None:
                split["idle_ms"] = ms - split["kernels_ms"] \
                    - split["other_device_ms"] - split["nccl_ms"]
            rows_out[name] = {
                "plan_s": plan_s, "support_sets_s": sum(sup_s),
                "launches": launches, "forms": forms,
                "words": words, "ms": ms, "device": split,
                "bf16_err": err,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if name == "sparse":
                rows_out[name]["meta"] = sparse_meta(prob)
            log(f"comm_sparse {sec}: {what} {ms:.2f} ms, {words:.4g} words")
            del prob
        report["cells"][f"{fam} c={c} {el}"] = rows_out
        del base
        torch.cuda.empty_cache()
    return report, totals


def phase_comm_sparse(torch, scale: int, reps: int):
    """Support-pruned communication on the card at r = 128: section A
    (correctness, R-MAT 2^min(16, scale)) and section B (full size,
    R-MAT 2^scale)."""
    ck = Checker(torch)
    r = 128
    t0 = time.perf_counter()
    check = comm_sparse_check(torch, ck, min(16, scale), r)
    emit({"phase": "comm_sparse", "section": "A", "r": r, "p": 8,
          "seconds": time.perf_counter() - t0, "checks": ck.n, **check})
    t0 = time.perf_counter()
    full, launches = comm_sparse_full(torch, ck, scale, r, reps)
    emit({"phase": "comm_sparse", "section": "B", "r": r, "p": 8,
          "seconds": time.perf_counter() - t0, "checks": ck.n, **full})
    t0 = time.perf_counter()
    full, more = comm_sparse_full(torch, ck, scale, r, min(reps, 3),
                                  permuted=False)
    emit({"phase": "comm_sparse", "section": "C", "r": r, "p": 8,
          "seconds": time.perf_counter() - t0, "checks": ck.n, **full})
    return {k: launches[k] + more[k] for k in launches}


def phase_rmat_padding(torch, scale: int):
    """The unpermuted R-MAT at 2^scale (see :func:`padding_check`)."""
    ck = Checker(torch)
    t0 = time.perf_counter()
    probe = padding_check(torch, ck, scale, 128, *PROBE_CELL)
    emit({"phase": "rmat_padding", "r": 128, "p": 8,
          "seconds": time.perf_counter() - t0, "checks": ck.n, **probe})


# ---------------------------------------------------------------------------
# dist: one rank per card over NCCL
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# train: the port's training path (core/grads, apps/als, apps/gat)
# ---------------------------------------------------------------------------

EMBED_LR = 0.05     # SGD rate of the sampled-loss steps (the loss falls)


# ---------------------------------------------------------------------------
# faults: recovery, re-planning and checkpoints on the card
# ---------------------------------------------------------------------------

#: stacked ranks of the faults phase's problem, and the rank it loses
FAULT_P, FAULT_LOST = 8, 7


def integer_problem(torch, m, per_row, r, seed):
    """The main configuration's ER matrix (drawn on the card) with
    integer values 1..4 and integer operands -3..3 (seeded on the card):
    every float32 accumulation is exact, so results on different grids
    agree bit for bit (check_remesh.py's data)."""
    rows, cols, _ = erdos_renyi_on_card(torch, m, m, per_row, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    vals = torch.randint(1, 5, (len(rows),), generator=g, device="cuda")
    X = torch.randint(-3, 4, (m, r), generator=g, device="cuda")
    Y = torch.randint(-3, 4, (m, r), generator=g, device="cuda")
    return (rows, cols, vals.float().cpu().numpy(), X.float(), Y.float())


def fault_calls(elisions, X, Y):
    """(label, op, elision, call) of every op of a family: ``call`` takes a
    DistProblem or an ElasticProblem (the same signatures) and returns
    device tensors (sampled values in host COO order)."""
    calls = [("sddmm", "sddmm", None,
              lambda p: (p.sddmm(X, Y).values_tensor(),)),
             ("spmm", "spmm", None, lambda p: (p.spmm(Y),)),
             ("spmm_t", "spmm_t", None, lambda p: (p.spmm_t(X),))]
    for el in elisions:
        def fused(p, el=el):
            out, R = p.fusedmm(X, Y, elision=el)
            return out, R.values_tensor()
        calls.append((f"fusedmm/{el}", "fusedmm", el, fused))
    return calls


def replayed_slots(prob, op, el):
    """Session entries one op's call leaves for its grid: the replicated
    operands its plan replays from a Session (two for s15's SDDMM and
    FusedMM, none for s25 or a d15/d25 SpMM)."""
    from repro_torch.core import api
    _, pre = prob.alg._words_plan(prob, op, el or "none", api.Session())
    return sum(pre) if isinstance(pre, tuple) else int(pre)


def device_gib(torch, *objs) -> float:
    """GiB of the distinct device storages reachable from ``objs``
    (tensors in dataclasses, dicts, lists and tuples)."""
    import dataclasses
    seen, stack = {}, list(objs)
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            st = o.untyped_storage()
            if o.device.type == "cuda":
                seen[st.data_ptr()] = st.nbytes()
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            stack += [getattr(o, f.name) for f in dataclasses.fields(o)]
        elif isinstance(o, dict):
            stack += list(o.values())
        elif isinstance(o, (list, tuple)):
            stack += list(o)
    return sum(seen.values()) / 2**30


def problem_gib(torch, prob) -> float:
    """GiB of a problem's device state: its plans, position-coded packs,
    value indices and device values, its transposed problem's too."""
    parts = [prob._plans, prob._posmaps, prob._value_idx, prob._vals_dev]
    if prob._transposed is not None:
        tp = prob._transposed
        parts += [tp._plans, tp._posmaps, tp._value_idx, tp._vals_dev]
    return device_gib(torch, *parts)


def timed_call(torch, fn):
    """(result, wall ms of one synchronised call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def faults_trainer(torch, ck, scale):
    """check_faults.py's guarantee 3 on the card: a DeviceLost at rank 7
    in the step-3 SDDMM of a 6-step train_embedding_distributed on 8
    stacked ranks ends with X, Y and the losses of steps 3-5 equal bit
    for bit to a fault-free run that checkpointed at step 3 and resumed
    on the degraded grid; the later checkpoint's meta records the new
    p."""
    import shutil
    import tempfile
    from repro_torch.apps import als
    from repro_torch.distributed import faults
    from repro_torch.training import checkpoint
    dev = torch.device("cuda")
    m = 1 << scale
    common = dict(m=m, n=m, nnz_per_row=16, r=128, lr=0.05, seed=3,
                  reg=0.0, verbose=False)
    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    runs = {}
    try:
        dir_a, dir_b, dir_c = (f"{tmp}/{d}" for d in "ABC")
        als.train_embedding_distributed(steps=3, ckpt_dir=dir_a,
                                        ckpt_every=3,
                                        devices=[dev] * FAULT_P, **common)
        shutil.copytree(dir_a, dir_b)
        runs["fault_free_s"] = time.perf_counter() - t0
        x_ref, y_ref, h_ref = als.train_embedding_distributed(
            steps=6, ckpt_dir=dir_b, ckpt_every=3, devices=[dev] * 4,
            **common)
        runs["resumed_s"] = time.perf_counter() - t0 - runs["fault_free_s"]
        plan = faults.FaultPlan.scripted(faults.FaultSpec(
            op="sddmm", rank=FAULT_LOST, round=3, kind="device_lost"))
        with faults.inject(plan) as ctl:
            x_rec, y_rec, h_rec = als.train_embedding_distributed(
                steps=6, ckpt_dir=dir_c, ckpt_every=3,
                devices=[dev] * FAULT_P, **common)
        if len(ctl.fired) != 1 or ctl.fired[0]["rank"] != FAULT_LOST:
            raise AssertionError(f"trainer: fired {ctl.fired}")
        ck.equal(x_rec, x_ref, "trainer: recovered X == resumed X")
        ck.equal(y_rec, y_ref, "trainer: recovered Y == resumed Y")
        if h_rec[3:] != h_ref:
            raise AssertionError(f"trainer: losses {h_rec[3:]} != {h_ref}")
        meta = checkpoint.load_manifest(dir_c, 6)["meta"]
        ref_meta = checkpoint.load_manifest(dir_b, 6)["meta"]
        if meta["p"] != 4 or meta != ref_meta:
            raise AssertionError(f"trainer: checkpoint meta {meta}")
        ck.n += 2
        return {"m": m, "losses": h_rec, "p_after": meta["p"],
                "family_after": meta["family"], "c_after": meta["c"],
                "seconds": time.perf_counter() - t0, **runs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_faults(torch, scale: int, apps_scale: int):
    """Recovery on the card at the main configuration (integer data):
    (a) "auto" on 8 stacked ranks, every op of its family fault-free;
    (b) ElasticProblem with a Session and a TransientFault mid-schedule
    in each call: recovered == (a) bit for bit, one recovery each, the
    Session evicting the entries the plan replays; (c) a DeviceLost at
    rank 7: degrade re-plans onto the largest feasible p, every op ==
    (a) bit for bit, the old problem's device state released first;
    (d) meta_dict -> problem_from_meta on 4 ranks: the same family and
    c, SDDMM == (a), a wrong COO refused; (e) the trainer's
    DeviceLost-vs-resume parity at 2^apps_scale.  Returns the launches
    of the phase."""
    import gc
    import weakref
    from repro_torch.core import api
    from repro_torch.distributed import faults
    from repro_torch.kernels import ops
    ck = Checker(torch)
    dev = torch.device("cuda")
    m, r = 1 << scale, 128
    rows, cols, vals, X, Y = integer_problem(torch, m, 16, r, 0)
    ops.reset_launch_counts()
    report, ms = {"m": m, "r": r, "nnz": int(len(vals))}, {}

    # (a) fault-free
    t0 = time.perf_counter()
    prob = api.make_problem(rows, cols, vals, (m, m), r,
                            devices=[dev] * FAULT_P)
    calls = fault_calls(prob.alg.elisions, X, Y)
    base = {}
    for label, _, _, call in calls:
        base[label], ms[f"a {label}"] = timed_call(torch,
                                                   lambda: call(prob))
        if not all(bool(torch.isfinite(t).all()) for t in base[label]):
            raise AssertionError(f"faults (a) {label}: non-finite")
    report["a"] = {"family": prob.alg.name, "c": prob.c, "p": prob.p,
                   "seconds": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"faults (a): {prob.alg.name} c={prob.c}, "
        f"{report['a']['seconds']:.1f} s")

    # (b) a transient fault mid-schedule in each call
    t0 = time.perf_counter()
    summaries, evicted = [], {}
    for label, op, el, call in calls:
        session = api.Session()
        call(api.ElasticProblem(prob, session=session))   # warm it
        plan = faults.FaultPlan.scripted(
            faults.FaultSpec(op=op, rank=1, phase=-1, round=0))
        with faults.inject(plan) as ctl:
            ep = api.ElasticProblem(prob, session=session)
            got, ms[f"b {label}"] = timed_call(torch, lambda: call(ep))
        if len(ctl.fired) != 1 or len(ep.recoveries) != 1:
            raise AssertionError(f"faults (b) {label}: fired {ctl.fired}, "
                                 f"recoveries {ep.recoveries}")
        want = replayed_slots(prob, op, el)
        if ep.recoveries[0]["evicted"] != want:
            raise AssertionError(f"faults (b) {label}: evicted "
                                 f"{ep.recoveries[0]['evicted']}, the "
                                 f"plan replays {want}")
        ck.equal_all(got, base[label], f"faults (b) {label} recovered")
        evicted[label] = want
        s = ctl.summary()
        s.pop("log")
        summaries.append(s)
        del got, session, ep
    report["b"] = {"evicted": evicted, "summaries": summaries,
                   "seconds": time.perf_counter() - t0}
    log(f"faults (b): {len(calls)} recovered calls bitwise, "
        f"{report['b']['seconds']:.1f} s")

    # (c) a lost rank: degrade, every op on the degraded grid
    t0 = time.perf_counter()
    degrade_s = []

    # what the cyclic collector would still free (nothing, if recovery
    # leaves no reference cycles), then what is held at the re-plan
    uncollected = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = {"all_gib": torch.cuda.memory_allocated() / 2**30,
            "cycles_gib": (uncollected - torch.cuda.memory_allocated())
            / 2**30,
            "old_problem_gib": problem_gib(torch, prob),
            "results_gib": device_gib(torch, base),
            "operands_gib": device_gib(torch, X, Y)}
    old = [weakref.ref(t) for q in (prob, prob.transposed())
           for t in (q.plan("normal").rows_local,
                     q._posplan("normal").rows_local)]
    plan = faults.FaultPlan.scripted(faults.FaultSpec(
        op="sddmm", rank=FAULT_LOST, round=0, kind="device_lost"))
    with faults.inject(plan) as ctl, \
            patched(api, "degrade", seconds_of(degrade_s)):
        ep = api.ElasticProblem(prob, session=api.Session())
        got, first_ms = timed_call(torch, lambda: calls[0][3](ep))
    gc.collect()
    if any(r() is not None for r in old):
        raise AssertionError("faults (c): the old problem's packs outlived "
                             "the re-plan")
    ck.n += 1
    new = ep.problem
    ck.equal_all(got, base["sddmm"], "faults (c) sddmm after degrade")
    del got
    for label, _, _, call in calls[1:]:
        got, ms[f"c {label}"] = timed_call(torch, lambda: call(ep))
        ck.equal_all(got, base[label], f"faults (c) {label} after degrade")
        del got
    report["c"] = {"family": new.alg.name, "c": new.c, "p": new.p,
                   "fired": ctl.fired, "recoveries": ep.recoveries,
                   "replan_host_s": degrade_s[0],
                   "first_call_ms": first_ms, "held": held,
                   "new_problem_gib": problem_gib(torch, new),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "seconds": time.perf_counter() - t0}
    log(f"faults (c): degraded to {new.alg.name} p={new.p} c={new.c} in "
        f"{degrade_s[0]:.3f} s, first call {first_ms:.0f} ms")
    meta = new.meta_dict()
    del ep, new, prob
    torch.cuda.empty_cache()

    # (d) the degraded problem's metadata through a checkpoint
    t0 = time.perf_counter()
    again = api.problem_from_meta(meta, rows, cols, vals,
                                  devices=[dev] * meta["p"])
    if (again.alg.name, again.c, again.p) != (meta["family"], meta["c"],
                                              meta["p"]):
        raise AssertionError(f"faults (d): rebuilt {again.alg.name} "
                             f"c={again.c} p={again.p} from {meta}")
    got, ms["d sddmm"] = timed_call(torch, lambda: calls[0][3](again))
    ck.equal_all(got, base["sddmm"], "faults (d) sddmm from meta")
    bad = vals.copy()
    bad[0] += 1.0
    try:
        api.problem_from_meta(meta, rows, cols, bad,
                              devices=[dev] * meta["p"])
    except ValueError as e:
        if "wrong matrix" not in str(e):
            raise
    else:
        raise AssertionError("faults (d): a wrong COO was accepted")
    ck.n += 2
    report["d"] = {"meta": meta, "seconds": time.perf_counter() - t0}
    del again, got, base
    torch.cuda.empty_cache()

    # (e) the trainer
    report["e"] = faults_trainer(torch, ck, apps_scale)
    launches = ops.launch_counts()
    for k in ("sddmm", "spmm"):
        if launches[k] <= 0:
            raise AssertionError(f"faults: {k} kernel not launched: "
                                 f"{launches}")
    report.update(launches=launches, forms=ops.form_counts(), ms=ms,
                  checks=ck.n)
    emit({"phase": "faults", **report})
    return launches


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def seconds_of(spent):
    """A ``patched`` wrapper recording each call's host seconds in
    ``spent`` (a call that raises too)."""
    def wrap(orig):
        def spy(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                spent.append(time.perf_counter() - t0)
        return spy
    return wrap


def counting_packs(torch, api, packs):
    """Record the host seconds of every packing (a position-coded plan
    made, ``DistProblem._posplan``) inside the block."""
    def wrap(orig):
        def spy(self, orient):
            if orient in self._posmaps:
                return orig(self, orient)
            t0 = time.perf_counter()
            out = orig(self, orient)
            torch.cuda.synchronize()
            packs.append(time.perf_counter() - t0)
            return out
        return spy
    return patched(api.DistProblem, "_posplan", wrap)


def marking_steps(torch, module, name, marks, packs):
    """Record (time, packs so far, arguments of the first call) at each
    call of ``module.name`` inside the block, the card synchronised
    first: one call a training step.  Only the first step's arguments
    are kept, so the spy holds no later step's tensors."""
    def wrap(orig):
        def spy(*args, **kwargs):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), len(packs),
                          None if marks else args))
            return orig(*args, **kwargs)
        return spy
    return patched(module, name, wrap)


def logging_calls(api, calls):
    """Record (executor, collective log) of every executor call inside
    the block."""
    def wrap(orig):
        def spy(self, prob, call, backend):
            out = orig(self, prob, call, backend)
            calls.append((call[0].__name__, prob.last_collectives.words()))
            return out
        return spy
    return patched(api.Algorithm, "_run", wrap)


def step_seconds(marks, t_end):
    return [b[0] - a[0] for a, b in zip(marks, marks[1:])] + \
        [t_end - marks[-1][0]]


def no_repacks(marks, packs, what):
    """Every packing happened in the first step."""
    if len(marks) < 2 or marks[1][1] != len(packs):
        raise AssertionError(f"{what}: a step after the first packed "
                             f"({[mk[1] for mk in marks]} of {len(packs)})")


def train_fusedmm(torch, ck, rows, cols, vals, m, r, reps):
    """Section A: grads.fusedmm forward + backward on d15, each cell."""
    from repro_torch.core import api, costmodel, grads
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(1)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((m, r), generator=g, device="cuda")
    W = torch.randn((m, r), generator=g, device="cuda")   # the cotangent
    packs = []
    with counting_packs(torch, api, packs):
        t0 = time.perf_counter()
        prob = api.make_problem(rows, cols, vals, (m, m), r, algorithm="d15")
        for P, o in ((prob, "normal"), (prob, "transpose"),
                     (prob.transposed(), "transpose")):
            P.plan(o)
        torch.cuda.synchronize()
        report = {"family": prob.alg.name, "p": prob.p, "c": prob.c,
                  "plan_s": time.perf_counter() - t0, "packs": packs,
                  "cells": {}}

    def leaves():
        return X.detach().requires_grad_(), Y.detach().requires_grad_()

    def step(el, session=None, backend=None):
        Xt, Yt = leaves()
        grads.fusedmm(prob, Xt, Yt, elision=el, session=session,
                      backend=backend).backward(W)
        return Xt.grad, Yt.grad

    total = {k: 0 for k in ops.KERNELS}
    for el in ("none", "reuse", "fused"):
        cell = {}
        # the counted pass: forward and backward read apart
        Xt, Yt = leaves()
        ops.reset_launch_counts()
        out = grads.fusedmm(prob, Xt, Yt, elision=el)
        torch.cuda.synchronize()
        fwd = ops.launch_counts()
        ops.reset_launch_counts()
        calls = []
        with logging_calls(api, calls):
            out.backward(W)
        torch.cuda.synchronize()
        bwd, forms = ops.launch_counts(), ops.form_counts()
        del out
        want = dict(fwd, spmm=fwd["spmm"] + 2)   # the same cell + 2 SpMM^T
        if bwd != want or not any(fwd.values()):
            raise AssertionError(f"train {el}: forward launched {fwd}, "
                                 f"backward {bwd}")
        if {f for k in forms.values() for f in k} != {"bulk"}:
            raise AssertionError(f"train {el}: backward forms {forms}")
        for k in total:
            total[k] += fwd[k] + bwd[k]
        cell.update(fwd_launches=fwd, bwd_launches=bwd, bwd_forms=forms)
        # the backward's collective log: each dual call's schedule
        models = [prob.schedule_words("fusedmm", el),
                  prob.schedule_words("spmm_t"),
                  prob.schedule_words("spmm_t")]
        if [c[0] for c in calls] != ["fusedmm_d15", "spmmb_d15",
                                     "spmmb_d15"]:
            raise AssertionError(f"train {el}: backward ran {calls}")
        for (fn, logged), model in zip(calls, models):
            if [(k, w) for k, w in logged if w] != [
                    (k, w) for (_, _, k, w) in model if k and w]:
                raise AssertionError(f"train {el} {fn}: log {logged} != "
                                     f"{model}")
            ck.n += 1
        cell["bwd_words_logged"] = sum(w for _, lg in calls for _, w in lg)
        cell["bwd_words_model"] = costmodel.words_fusedmm_bwd(
            costmodel.ELISION_COST_NAME[("d15", el)], p=prob.p, c=prob.c,
            n=m, r=r, nnz=prob.nnz).words
        # against the plain kernels
        gx, gy = Xt.grad, Yt.grad
        rx, ry = step(el, backend="ref")
        cell["max_abs_err"] = max(
            ck.close(gx, rx, 2e-3, f"train {el} dX vs ref"),
            ck.close(gy, ry, 2e-3, f"train {el} dY vs ref"))
        del Xt, Yt, rx, ry
        # the memory of one step without and with a Session (which
        # changes no bit): the peak, and what the step added to what was
        # allocated before it
        del gx, gy
        sess = api.Session()
        for key, kw in (("", {}), ("_session", {"session": sess})):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            got = step(el, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            cell["peak_gib" + key] = peak / 2**30
            cell["step_gib" + key] = (peak - before) / 2**30
            if kw:
                ck.equal(got[0], plain[0], f"train {el} session dX")
                ck.equal(got[1], plain[1], f"train {el} session dY")
            plain = got
        del got, plain
        cell["ms"] = time_ms(torch, lambda: step(el), reps)
        cell["ms_session"] = time_ms(torch, lambda: step(el, session=sess),
                                     reps)
        cell["session"] = sess.stats()
        del sess
        cell["device"] = device_breakdown(torch, lambda: step(el))
        report["cells"][el] = cell
        torch.cuda.empty_cache()
    report["replaced"] = replaced_paths(torch, ck, prob, X, Y)
    return report, total


def replaced_paths(torch, ck, prob, X, Y):
    """What the backward's three host paths cost at this size against
    their device replacements, on the same data: the sampled values in
    host-COO order (``values()`` on the host / ``values_tensor``), values
    put into the packs (a re-pack, what ``injected_plan`` did from 2^24
    nonzeros / the device gather), and a Session key (the operand copied
    to the host and blake2b-hashed / the device bit sum and compare)."""
    import hashlib
    from repro_torch.core import api
    _, R = prob.fusedmm(X, Y, elision="fused")
    t0 = time.perf_counter()
    host = R.values()
    out = {"values_host_s": time.perf_counter() - t0}
    dev = R.values_tensor()
    ck.equal(dev.view(torch.int32),
             torch.from_numpy(host).cuda().view(torch.int32),
             "values_tensor == values(), full size")
    out["values_tensor_ms"] = time_ms(torch, R.values_tensor, 3)
    t0 = time.perf_counter()
    repacked = prob.alg.make_plan(prob._derive(vals=host), "normal")
    torch.cuda.synchronize()
    out["repack_s"] = time.perf_counter() - t0
    got = prob.injected_plan("normal", dev)
    for a, b in zip(got.vals, repacked.vals):
        ck.equal(a, b, "injected_plan == re-pack, full size")
    del got, repacked, R, host
    out["injected_plan_ms"] = time_ms(
        torch, lambda: prob.injected_plan("normal", dev), 3)
    t0 = time.perf_counter()
    hashlib.blake2b(X.cpu().numpy().tobytes(), digest_size=16).hexdigest()
    out["host_key_s"] = time.perf_counter() - t0
    sess = api.Session()
    sess.replicate(prob, X, "x")
    # another object with the same bytes each time: summed and compared
    out["device_key_ms"] = time_ms(
        torch, lambda: sess.replicate(prob, X.detach(), "x"), 3)
    if sess.misses != 1:
        raise AssertionError(f"device key: {sess.stats()}")
    return out


def train_embedding(torch, ck, rows, cols, vals, m, r, reps):
    """Section B: train_embedding_distributed, 3 SGD steps."""
    from repro_torch.apps import als
    from repro_torch.core import api
    from repro_torch.kernels import ops
    packs, marks = [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with counting_packs(torch, api, packs), \
            marking_steps(torch, als, "sampled_loss", marks, packs):
        X, Y, hist = als.train_embedding_distributed(
            m=m, n=m, r=r, steps=3, lr=EMBED_LR, rows=rows, cols=cols,
            vals=np.abs(vals) + 0.5, verbose=False)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    report = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "loss": hist, "step_s": step_seconds(marks, t_end),
              "plan_s": sum(packs), "packs": packs}
    del X, Y
    if not hist[-1] < hist[0]:
        raise AssertionError(f"embedding loss did not fall: {hist}")
    no_repacks(marks, packs, "embedding")
    maskP, X0, Y0, targets, reg = marks[0][2][:5]
    report.update(family=maskP.alg.name, c=maskP.c, p=maskP.p)

    def grads_of(backend=None, session=None):
        Xl, Yl = X0.detach().requires_grad_(), Y0.detach().requires_grad_()
        loss = als.sampled_loss(maskP, Xl, Yl, targets, reg,
                                session=session, backend=backend)
        return torch.autograd.grad(loss, (Xl, Yl))

    # step 1's gradients, counted, against the plain kernels
    ops.reset_launch_counts()
    gx, gy = grads_of(session=api.Session())
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    report.update(launches=launches, forms=ops.form_counts())
    if launches["sddmm"] <= 0 or launches["spmm"] <= 0:
        raise AssertionError(f"embedding step launched {launches}")
    rx, ry = grads_of(backend="ref")
    report["max_abs_err"] = max(
        ck.close(gx, rx, 2e-3, "embedding step 1 dX vs ref"),
        ck.close(gy, ry, 2e-3, "embedding step 1 dY vs ref"))
    del gx, gy, rx, ry
    # a step as the app takes it: new factors, so a Session of misses
    report["ms"] = time_ms(torch, lambda: grads_of(session=api.Session()),
                           reps)
    report["device"] = device_breakdown(
        torch, lambda: grads_of(session=api.Session()))
    del marks, maskP, X0, Y0, targets
    torch.cuda.empty_cache()
    return report, launches


def train_apps(torch, ck, scale, reps):
    """Section C: one ALS round and three GAT training steps at full
    width on 2^scale rows."""
    from repro_torch.apps import als, gat
    from repro_torch.core import api
    from repro_torch.kernels import ops
    m, r, per_row = 1 << scale, 128, 16
    total = {k: 0 for k in ops.KERNELS}
    report = {"m": m, "r": r, "nnz_per_row": per_row}

    # ALS: one round of two CG solves, 10 iterations each; the ratings
    # (|v| + 0.5) and the factors (0.1 N(0, 1)) drawn on the card
    packs = []
    torch.cuda.reset_peak_memory_stats()
    with counting_packs(torch, api, packs):
        t0 = time.perf_counter()
        rows, cols, vals = erdos_renyi_on_card(torch, m, m, per_row, 0)
        ratings = api.make_problem(rows, cols, np.abs(vals) + 0.5, (m, m),
                                   r)
        del rows, cols, vals
        ratings_t = ratings.transposed()
        # what als.make_dist_problem builds from a host-drawn matrix
        dp = als.DistALSProblem(ratings, ratings_t, ratings.ones(),
                                ratings_t.ones(), m, m, r)
        g = torch.Generator(device="cuda").manual_seed(1)
        A, B = (torch.randn((m, r), generator=g, device="cuda") * 0.1
                for _ in range(2))
        loss0 = als.dist_loss(dp, A, B)
        setup_s = time.perf_counter() - t0
        sess = api.Session()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        A1, B1 = als.dist_als_round(dp, A, B, cg_iters=10, session=sess)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        packs_in_round = len(packs)
        t0 = time.perf_counter()
        A2, B2 = als.dist_als_round(dp, A1, B1, cg_iters=10, session=sess)
        torch.cuda.synchronize()
        round2_s = time.perf_counter() - t0
    if len(packs) != packs_in_round:
        raise AssertionError("ALS: the second round packed")
    losses = [loss0, als.dist_loss(dp, A1, B1), als.dist_loss(dp, A2, B2)]
    if not losses[1] < losses[0]:
        raise AssertionError(f"ALS loss did not fall: {losses}")
    if launches["fusedmm"] + launches["sddmm"] <= 0:
        raise AssertionError(f"ALS round launched {launches}")
    for k in total:
        total[k] += launches[k]
    report["als"] = {
        "family": dp.mask.alg.name, "c": dp.mask.c, "nnz": dp.mask.nnz,
        "elision": dp.mask.resolve_elision("auto", sess),
        "setup_s": setup_s, "plan_s": sum(packs), "packs": packs,
        "round_s": [round_s, round2_s], "loss": losses,
        "launches": launches, "forms": ops.form_counts(),
        "session": sess.stats(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "matvec_ms": time_ms(torch, lambda: als.dist_fusedmm_matvec(
            dp.mask, A1, B1, dp.reg, sess), reps),
        "matvec_device": device_breakdown(torch, lambda: (
            als.dist_fusedmm_matvec(dp.mask, A1, B1, dp.reg, sess)))}
    del dp, ratings, ratings_t, A, B, A1, B1, A2, B2, sess
    torch.cuda.empty_cache()

    # GAT: three SGD steps of one layer, 16 neighbours a row + self loops
    packs, marks = [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows, cols = gat_graph_on_card(torch, m, per_row, 0)
    gp = api.make_problem(rows, cols, np.ones(len(rows), np.float32), (m, m),
                          r)
    del rows, cols
    g = torch.Generator(device="cuda").manual_seed(2)
    H = torch.randn((m, r), generator=g, device="cuda")
    target = torch.randn((m, r), generator=g, device="cuda") * 0.1
    setup_s = time.perf_counter() - t0
    with counting_packs(torch, api, packs), \
            marking_steps(torch, gat, "gat_layer_trainable", marks, packs):
        _, hist = gat.train_gat_distributed(gp, H, target, steps=3,
                                            lr=0.05, seed=0, verbose=False)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    if not hist[-1] < hist[0]:
        raise AssertionError(f"GAT loss did not fall: {hist}")
    no_repacks(marks, packs, "GAT")
    step_s = step_seconds(marks, t_end)
    del marks
    # the trainable layer is the distributed one, at the initial params
    p0 = gat.init_gat_layer(torch.Generator(device="cuda").manual_seed(0),
                            r, r)
    want = gat.gat_layer_distributed(gp, H, p0)
    leaves = [t.clone().requires_grad_() for t in (p0.W, p0.a1, p0.a2)]

    def gat_step():
        out = gat.gat_layer_trainable(gp, H, *leaves)
        return torch.autograd.grad(torch.mean((out - target) ** 2), leaves)

    ops.reset_launch_counts()
    got = gat.gat_layer_trainable(gp, H, *leaves)
    first = torch.autograd.grad(torch.mean((got - target) ** 2), leaves)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for a, b in zip(first, gat_step()):
        ck.equal(a, b, "GAT gradients repeat bit for bit")
    for k in total:
        total[k] += launches[k]
    report["gat"] = {
        "family": gp.alg.name, "c": gp.c, "nnz": gp.nnz,
        "setup_s": setup_s, "plan_s": sum(packs), "packs": packs,
        "loss": hist, "step_s": step_s,
        "max_abs_err_vs_distributed": ck.close(
            got.detach(), want, 5e-4, "GAT trainable vs distributed"),
        "launches": launches, "forms": ops.form_counts(),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "ms": time_ms(torch, gat_step, reps),
        "device": device_breakdown(torch, gat_step)}
    return report, total


def phase_train(torch, scale: int, apps_scale: int, reps: int):
    """The training path on the card: sections A (grads.fusedmm on d15),
    B (sampled-loss SGD) and C (ALS and GAT)."""
    ck = Checker(torch)
    m, r = 1 << scale, 128
    t0 = time.perf_counter()
    rows, cols, vals = erdos_renyi_on_card(torch, m, m, 16, 0)
    report = {"phase": "train", "m": m, "r": r, "nnz": int(len(vals)),
              "gen_s": time.perf_counter() - t0, "seconds": {}}
    t0 = time.perf_counter()
    report["fusedmm"], total = train_fusedmm(torch, ck, rows, cols, vals, m,
                                             r, reps)
    report["seconds"]["fusedmm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["embedding"], launches = train_embedding(torch, ck, rows, cols,
                                                    vals, m, r, reps)
    report["seconds"]["embedding"] = time.perf_counter() - t0
    for k in total:
        total[k] += launches[k]
    del rows, cols, vals
    t0 = time.perf_counter()
    report["apps"], launches = train_apps(torch, ck, apps_scale, reps)
    report["seconds"]["apps"] = time.perf_counter() - t0
    for k in total:
        total[k] += launches[k]
    report["launches"] = total
    report["checks"] = ck.n
    emit(report)
    return total


# ---------------------------------------------------------------------------
# obs: tracing, drift, the kernel router and conformance on the card
# ---------------------------------------------------------------------------

#: the main path's calls the obs phase traces, each without and with a
#: Session
OBS_CALLS = [("sddmm", "none"), ("spmm", "none"), ("spmm_t", "none"),
             ("fusedmm", "none"), ("fusedmm", "reuse"), ("fusedmm", "fused")]
#: the drift section's size: ER 2^OBS_DRIFT_SCALE at p = 8, c = 2 stacked
OBS_DRIFT_SCALE = 18
OBS_P, OBS_C = 8, 2


def obs_call(prob, op, el, X, Y, session=None):
    """One call of ``op`` (``el`` for fusedmm) through the problem."""
    if op == "sddmm":
        return prob.sddmm(X, Y, session=session)
    if op == "spmm":
        return prob.spmm(Y, session=session)
    if op == "spmm_t":
        return prob.spmm_t(X, session=session)
    return prob.fusedmm(X, Y, elision=el, session=session)


def result_tensors(res):
    """The tensors of a result: dense outputs, a SparseResult's raw
    values (one tensor a phase for d15)."""
    from repro_torch.core import api
    if isinstance(res, api.SparseResult):
        return _leaves(res.raw)
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in result_tensors(r)]
    return [res]


def _counts_delta(ops, before):
    now = ops.form_counts()
    return {k: {f: n - before[k].get(f, 0) for f, n in v.items()
                if n - before[k].get(f, 0)} for k, v in now.items()}


def check_spans(ck, prob, rnd, what):
    """A round span's events align with the schedule and tile it."""
    ev = prob.alg.schedule_events(prob, rnd.op, rnd.elision)
    if [(e.point, e.phase) for e in rnd.events] != ev:
        raise AssertionError(f"{what}: spans {rnd.events} vs schedule {ev}")
    t = rnd.t0
    for e in rnd.events:
        if abs(e.t0 - t) > 1e-9 + 1e-6 * abs(t):
            raise AssertionError(f"{what}: event spans leave a gap")
        t += e.dur
    if abs(t - (rnd.t0 + rnd.dur)) > 1e-9 + 1e-6 * rnd.dur:
        raise AssertionError(f"{what}: event spans do not tile the round")
    if prob.grid.device.type == "cuda" and rnd.device_ms is None:
        raise AssertionError(f"{what}: no device time on the card")
    ck.n += 1


def loop_ms(torch, fn, n: int) -> float:
    """Device milliseconds a call of ``fn`` over ``n`` calls queued back
    to back (events around them, one synchronize).  One more call goes
    first, untimed, so the card is busy while the timed calls are
    queued and no launch's host latency lands in the span."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    fn()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def obs_main_path(torch, ck, prob, X, Y, reps):
    """(A) The main path traced at full width: each call of OBS_CALLS,
    without and with a Session (a fresh one for the untraced calls and
    one for the traced), untraced then traced; the first traced result
    == the first untraced bit for bit, one round span per traced call
    aligned with the schedule and tiling it, the hand-written kernels
    launched inside the traced rounds; each cell's traced rounds' median
    device ms beside the untraced call's median (``time_ms``), and the
    ms a call of ``reps`` calls back to back (``loop_ms``), untraced and
    traced in turns (untraced, traced, traced, untraced): what tracing
    costs.  A cell traces 2 ``reps`` + 3 rounds.  The Chrome trace is
    written under chiprun_out/."""
    from repro_torch import obs
    from repro_torch.core import api
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    prob.transposed().plan("transpose")    # spmm_t's pack, planned once
    torch.cuda.synchronize()
    pack_t_s = time.perf_counter() - t0
    tr = obs.Tracer()
    forms = {k: {} for k in ops.KERNELS}

    def traced(fn):
        before = ops.form_counts()
        with obs.trace(tr):
            out = fn()
        for k, v in _counts_delta(ops, before).items():
            for f, n in v.items():
                forms[k][f] = forms[k].get(f, 0) + n
        return out

    cells = []
    for op, el in OBS_CALLS:
        for with_s in (False, True):
            tag = op + (f"[{el}]" if op == "fusedmm" else "") \
                + ("+sess" if with_s else "")
            s_u = api.Session() if with_s else None
            s_t = api.Session() if with_s else None
            base = result_tensors(obs_call(prob, op, el, X, Y, s_u))
            untraced_ms = time_ms(
                torch, lambda: obs_call(prob, op, el, X, Y, s_u), reps)
            n0 = len(tr._rounds)
            got = traced(lambda: result_tensors(
                obs_call(prob, op, el, X, Y, s_t)))
            if len(got) != len(base):
                raise AssertionError(f"obs {tag}: result structure")
            for a, b in zip(got, base):
                ck.equal(a, b, f"obs {tag} traced == untraced")
            del got, base
            loops = {"untraced": [], "traced": []}
            for kind in ("untraced", "traced", "traced", "untraced"):
                sess = s_t if kind == "traced" else s_u

                def run():
                    return loop_ms(torch, lambda: obs_call(
                        prob, op, el, X, Y, sess), reps)
                loops[kind].append(traced(run) if kind == "traced"
                                   else run())
            if len(tr._rounds) - n0 != 2 * reps + 3:
                raise AssertionError(f"obs {tag}: {len(tr._rounds) - n0} "
                                     f"round spans for {2 * reps + 3} "
                                     f"calls")
            cells.append((tag, n0, untraced_ms, loops))
            torch.cuda.empty_cache()
    rounds = tr.rounds                      # one synchronize
    out = {}
    for tag, n0, untraced_ms, loops in cells:
        mine = rounds[n0:n0 + 2 * reps + 3]
        for rnd in mine:
            check_spans(ck, prob, rnd, f"obs {tag}")
        out[tag] = {"traced_ms": statistics.median(r.dur * 1e3
                                                   for r in mine),
                    "untraced_ms": untraced_ms,
                    "untraced_loop_ms": loops["untraced"],
                    "traced_loop_ms": loops["traced"]}
    launches = {k: sum(v.values()) for k, v in forms.items()}
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"obs: {k} not launched in the traced "
                                 f"rounds: {forms}")
    if {f for v in forms.values() for f in v} != {"bulk"}:
        raise AssertionError(f"obs: traced rounds took forms {forms}")
    out_dir = ROOT / "chiprun_out"
    paths = obs.write_artifacts(str(out_dir), "obs_main", tracer=tr)
    size = pathlib.Path(paths["trace"]).stat().st_size
    return {"rounds": len(rounds), "pack_transposed_s": pack_t_s,
            "cells": out,
            "launches": launches, "forms": forms,
            "trace": str(pathlib.Path(paths["trace"]).relative_to(ROOT)),
            "trace_bytes": size}


def spans_by_kind(rounds):
    """{kind: device ms, bytes, moves, GB/s} from event spans: each
    event's moves' device time and its words (4 bytes a word)."""
    out = {}
    for rnd in rounds:
        for e in rnd.events:
            if not e.words or e.device_ms is None:
                continue
            k = out.setdefault(e.kind, {"ms": 0.0, "bytes": 0.0,
                                        "moves": 0})
            k["ms"] += e.device_ms
            k["bytes"] += 4 * e.words
            k["moves"] += e.moves
    for k in out.values():
        k["gb_per_s"] = k["bytes"] / k["ms"] / 1e6 if k["ms"] else None
    return out


def obs_drift(torch, ck, scale):
    """(B) Drift at p = 8 stacked, c = 2, ER 2^scale, r = 128, in all
    four families: every dense op and cell without and with a Session,
    each called twice (drift within [0.99, 1.01], each round's per-event
    modeled words summing to its model) and one comm="sparse" cell a
    family (no model, no drift); each second (warm) call's device ms,
    and device ms, GB/s and moves per collective kind from the warm
    calls' spans (a first call also packs its plan and allocates)."""
    from repro_torch import obs
    from repro_torch.core import api
    m = n = 1 << scale
    r = 128
    rows, cols, vals = erdos_renyi_on_card(torch, m, n, 16, 3)
    g = torch.Generator(device="cuda").manual_seed(4)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((n, r), generator=g, device="cuda")
    devs = [torch.device("cuda")] * OBS_P
    tr = obs.Tracer()
    fams = {}
    t0 = time.perf_counter()
    for fam in ("d15", "s15", "d25", "s25"):
        prob = api.make_problem(rows, cols, vals, (m, n), r, algorithm=fam,
                                c=OBS_C, devices=devs)
        n0 = len(tr._rounds)
        with obs.trace(tr):
            for op, el in OBS_CALLS:
                if op == "fusedmm" and el not in prob.alg.elisions:
                    continue
                for with_s in (False, True):
                    sess = api.Session() if with_s else None
                    obs_call(prob, op, el, X, Y, sess)
                    obs_call(prob, op, el, X, Y, sess)
        dense_n = len(tr._rounds) - n0
        sp = api.make_problem(rows, cols, vals, (m, n), r, algorithm=fam,
                              c=OBS_C, devices=devs, comm="sparse")
        with obs.trace(tr):
            obs_call(sp, "fusedmm", prob.alg.elisions[0], X, Y)
        fams[fam] = (prob, n0, dense_n)
        del sp
        torch.cuda.empty_cache()
    plan_and_run_s = time.perf_counter() - t0
    rounds = tr.rounds
    out = {"m": m, "r": r, "p": OBS_P, "c": OBS_C, "families": {},
           "seconds": plan_and_run_s}
    for fam, (prob, n0, dense_n) in fams.items():
        dense = rounds[n0:n0 + dense_n]
        warm = dense[1::2]
        sparse_rnd = rounds[n0 + dense_n]
        drifts = []
        for rnd in dense:
            what = f"obs drift {fam} {rnd.op}[{rnd.elision}]" \
                + ("+sess" if rnd.session else "")
            check_spans(ck, prob, rnd, what)
            if rnd.drift is None or not 0.99 <= rnd.drift <= 1.01:
                raise AssertionError(f"{what}: drift {rnd.drift}")
            if sum(e.words for e in rnd.events) != rnd.modeled_words:
                raise AssertionError(f"{what}: event words do not sum to "
                                     f"the round's model")
            drifts.append(rnd.drift)
            ck.n += 1
        if sparse_rnd.comm != "sparse" or sparse_rnd.modeled_words \
                is not None or sparse_rnd.drift is not None:
            raise AssertionError(f"obs drift {fam}: the sparse round has a "
                                 f"model or a drift")
        ck.n += 1
        out["families"][fam] = {
            "rounds": dense_n, "drift_min": min(drifts),
            "drift_max": max(drifts),
            "round_ms": {f"{r_.op}[{r_.elision}]"
                         + ("+sess" if r_.session else ""): r_.dur * 1e3
                         for r_ in warm},
            "sparse_first_ms": sparse_rnd.dur * 1e3,
            "sparse_words": sparse_rnd.measured_words["total"],
            "comm": spans_by_kind(warm)}
    return out


def obs_router(torch, ck, prob, S, X, Y):
    """(C) The router at full width: ``api.activate(prob, S)`` with S the
    local pack of the same matrix; routed ops == the problem's own
    results bit for bit and within 2e-3 of the local kernels on S,
    another pack falls through, ``backend="ref"`` wins, the hook is
    cleared afterwards."""
    import dataclasses
    from repro_torch.core import api
    from repro_torch.kernels import ops
    m = prob.m
    if tuple(S.shape) != (prob.m, prob.n):
        raise AssertionError(f"router: pack of shape {S.shape}")
    local = {"sddmm": ops.sddmm(X, Y, S, backend="cuda").vals,
             "spmm": ops.spmm(S, Y, m=m, backend="cuda")}
    lf, lR = ops.fusedmm(X, Y, S, m=m, backend="cuda")
    t0 = time.perf_counter()
    with api.activate(prob, S) as router:
        idx, ok = router._slot_index()
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        R_ = ops.sddmm(X, Y, S)
        out = ops.spmm(S, Y, m=m)
        f, fR = ops.fusedmm(X, Y, S, m=m)
        torch.cuda.synchronize()
        routed_s = time.perf_counter() - t0
        if router.routed != 3:
            raise AssertionError(f"router routed {router.routed} calls")
        other = dataclasses.replace(S)
        fell = ops.spmm(other, Y, m=m)
        ref = ops.spmm(S, Y, m=m, backend="ref")
        if router.routed != 3:
            raise AssertionError("another pack or backend='ref' routed")
        ck.equal(fell, local["spmm"], "router: another pack falls through")
        err_ref = ck.close(ref, local["spmm"], 2e-3, "router: ref wins")
        del fell, ref, other
    if ops._DIST_ROUTER is not None:
        raise AssertionError("router: hook left set")
    ck.n += 1
    want_R = prob.sddmm(X, Y).values_tensor()
    ck.equal(R_.vals.reshape(-1)[ok], want_R[idx[ok]],
             "router sddmm == problem")
    if bool((R_.vals.reshape(-1)[~ok] != 0).any()):
        raise AssertionError("router sddmm: padding slots not zero")
    ck.equal(out, prob.spmm(Y), "router spmm == problem")
    want_f, want_fR = prob.fusedmm(X, Y)
    ck.equal(f, want_f, "router fusedmm == problem")
    ck.equal(fR.vals.reshape(-1)[ok], want_fR.values_tensor()[idx[ok]],
             "router fusedmm R == problem")
    del want_R, want_f, want_fR
    errs = {"sddmm": ck.close(R_.vals, local["sddmm"], 2e-3,
                              "router sddmm vs local"),
            "spmm": ck.close(out, local["spmm"], 2e-3,
                             "router spmm vs local"),
            "fusedmm": ck.close(f, lf, 2e-3, "router fusedmm vs local"),
            "fusedmm_R": ck.close(fR.vals, lR.vals, 2e-3,
                                  "router fusedmm R vs local"),
            "ref_vs_local": err_ref}
    return {"slot_index_s": index_s, "routed_calls_s": routed_s,
            "max_abs_err_vs_local": errs}


def obs_conformance(torch, ck):
    """(D) Every registry cell, dense and sparse, on 8 stacked ranks on
    the card at the reference's sweep size (64 x 64, r = 16)."""
    from repro_torch.analysis import conformance
    t0 = time.perf_counter()
    rep = conformance.run_conformance(
        devices=[torch.device("cuda")] * OBS_P)
    bad = [(c["cell"], c["errors"]) for c in rep["cells"]
           if c["verdict"] != "pass"]
    if bad:
        raise AssertionError(f"conformance on the card: {bad}")
    ck.n += len(rep["cells"])
    return {"cells": len(rep["cells"]), "pass": rep["pass"],
            "structural": rep["structural"],
            "seconds": time.perf_counter() - t0}


def phase_obs(torch, scale: int, reps: int, main_state=None):
    """The obs phase: (A) the main path traced at full width, (B) drift
    at p = 8 stacked, (C) the router at full width, (D) conformance on
    the card.  Reuses the main phase's problem and pack where that phase
    ran; returns the launches of (A)'s traced rounds."""
    from repro_torch.core import api
    ck = Checker(torch)
    if main_state is None:
        m = n = 1 << scale
        rows, cols, vals = erdos_renyi_on_card(torch, m, n, 16, 0)
        g = torch.Generator(device="cuda").manual_seed(1)
        X = torch.randn((m, 128), generator=g, device="cuda")
        Y = torch.randn((n, 128), generator=g, device="cuda")
        prob = api.make_problem(rows, cols, vals, (m, n), 128,
                                algorithm="d15")
        S = main_pack(prob)
    else:
        prob, S, X, Y = (main_state[k] for k in ("prob", "S", "X", "Y"))
    rep = {"phase": "obs", "m": prob.m, "r": prob.r, "nnz": prob.nnz}
    t0 = time.perf_counter()
    rep["main"] = obs_main_path(torch, ck, prob, X, Y, reps)
    rep["main"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep["router"] = obs_router(torch, ck, prob, S, X, Y)
    rep["router"]["seconds"] = time.perf_counter() - t0
    launches = rep["main"]["launches"]
    del prob, S, X, Y
    if main_state is not None:
        main_state.clear()
    torch.cuda.empty_cache()
    rep["drift"] = obs_drift(torch, ck, OBS_DRIFT_SCALE)
    torch.cuda.empty_cache()
    rep["conformance"] = obs_conformance(torch, ck)
    rep["checks"] = ck.n
    emit(rep)
    return launches


NVLINK_GB_PER_S = 450.0   # H100 SXM NVLink 4, each direction (data sheet)
DIST_TIMEOUT_S = 900      # the dist phase's ranks, spawn to exit
#: (algorithm, cells): d15's three cells are the main path on the cards;
#: then "auto" and one more cell of its family (s15 at the main path's
#: point), d25's and s25's "auto" cell, each family at the c the cost
#: model picks for it at the group's p
DIST_PROBLEMS = [("d15", ("none", "reuse", "fused")),
                 ("auto", ("auto", "reuse")),
                 ("d25", ("auto",)), ("s25", ("auto",))]
#: at world size 1 no collective crosses a rank: one cell shows that NCCL
#: starts and the path runs
DIST_PROBLEMS_ONE = [("d15", ("fused",))]


def _timed_backend(torch):
    """The serial pass's collective backend: the port's per-move timer
    (``repro_torch.obs.moves``, CUDA events around each move) with the
    ranks lined up before each move (the card idle, then an all-reduce
    of one word), so a span holds the transfer and not a wait for a
    peer's kernel.  ``comm_by_kind`` reads it."""
    from repro_torch.obs import moves

    def timed(grid):
        return moves.timed_backend(grid, barrier=True)

    return timed


def comm_by_kind(coll):
    """{kind: ms, bytes, moves, GB/s and share of NVLink's rate} over the
    collectives of a timed backend that crossed a rank."""
    out = coll.by_kind()
    for k in out.values():
        k["nvlink_share"] = (k["gb_per_s"] / NVLINK_GB_PER_S
                             if k["gb_per_s"] else None)
    return out


def dist_rank(rank: int, world: int, init: str, scale: int, reps: int,
              comm_scale: int, out_dir: str, apps_scale: int = 20,
              only: str | None = None) -> None:
    """One rank of the dist phase, on card ``rank``, over NCCL; writes its
    report to ``out_dir``.  Any failed check raises (a non-zero exit)."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=init, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        report = _dist_rank(torch, dist, rank, world, scale, reps,
                            comm_scale, apps_scale, only, out_dir)
    except BaseException:
        # leave at once: the peers may wait in a collective this rank
        # never joins, and destroy_process_group would wait with them
        import os
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(report, f)


def _leaves(res):
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _leaves(r)]
    return [res]


def _dist_rank(torch, dist, rank, world, scale, reps, comm_scale,
               apps_scale, only=None, out_dir=None):
    import gc
    t_rank = time.perf_counter()
    ck = Checker(torch)
    report = {"rank": rank, "world": world, "problems": {}}
    if only is None:
        _dist_cells(torch, dist, ck, rank, world, scale, reps, comm_scale,
                    report)
    if only in (None, "serving"):
        _dist_serving(torch, dist, ck, rank, world, scale, apps_scale,
                      t_rank, report)
    if only in (None, "train"):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"dist rank {rank}: the train cells start at "
            f"+{time.perf_counter() - t_rank:.1f} s")
        report["train"] = dist_train(torch, dist, ck, rank, world, out_dir)
    if only == "tp_sums" and world == DIST_TP_WORLD:
        report["tp_sums"] = dist_tp_sum_forms(torch, dist, ck, rank, world,
                                              DIST_TP_SUM_REPS)
    elif only in (None, "tp") and world == DIST_TP_WORLD:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"dist rank {rank}: the tensor-parallel cells start at "
            f"+{time.perf_counter() - t_rank:.1f} s")
        report["tp"] = dist_tp(torch, dist, ck, rank, world, out_dir)
    elif only in ("tp", "tp_sums"):
        raise AssertionError(f"dist tp: the cells need {DIST_TP_WORLD} "
                             f"cards, {world} visible")
    if only in (None, "fsdp") and world == DIST_TP_WORLD:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"dist rank {rank}: the FSDP cells start at "
            f"+{time.perf_counter() - t_rank:.1f} s")
        report["fsdp"] = dist_fsdp(torch, dist, ck, rank, world, out_dir)
    elif only == "fsdp":
        raise AssertionError(f"dist fsdp: the cells need {DIST_TP_WORLD} "
                             f"cards, {world} visible")
    if only == "serve_tp" and world == DIST_TP_WORLD:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"dist rank {rank}: the serving cells on the model axis start "
            f"at +{time.perf_counter() - t_rank:.1f} s")
        report["serve_tp"] = dist_serve_tp(torch, dist, ck, rank, world,
                                           out_dir)
    elif only == "serve_tp":
        raise AssertionError(f"dist serve tp: the cells need "
                             f"{DIST_TP_WORLD} cards, {world} visible")
    report["checks"] = ck.n
    return report


def _dist_serving(torch, dist, ck, rank, world, scale, apps_scale, t_rank,
                  report):
    """Serving on the group into ``report``, each cell's launches counted
    on this rank in its served segments alone (LaunchWindows)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log(f"dist rank {rank}: the serving cells start at "
        f"+{time.perf_counter() - t_rank:.1f} s")
    t0 = time.perf_counter()
    if world > 1:
        serve = {"als": dist_serving(torch, dist, ck, rank, world, scale),
                 "gat": dist_serving_gat(torch, dist, ck, rank, world,
                                         apps_scale)}
    else:
        serve = {"one": dist_serving_one(torch, dist, ck, min(
            scale, DIST_SERVE_ONE_SCALE))}
    torch.cuda.synchronize()
    serve.update(launches={cell: rec["launches"]
                           for cell, rec in serve.items()},
                 seconds=time.perf_counter() - t0)
    report["serving"] = serve


def _dist_cells(torch, dist, ck, rank, world, scale, reps, comm_scale,
                report):
    """The dist phase's cells before serving, into ``report``: the
    families' cells beside the stacked run, then (world > 1) the sampled
    loss, the R-MAT cells and the fault cells."""
    from repro_torch.core import api, costmodel
    from repro_torch.kernels import ops
    dev = torch.device("cuda", rank)
    m = n = 1 << scale
    r, per_row, seed = 128, 16, 0
    rows, cols, vals = erdos_renyi_on_card(torch, m, n, per_row, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((n, r), generator=g, device="cuda")
    Timed = _timed_backend(torch)
    report.update(m=m, r=r, nnz=int(len(vals)))
    for algorithm, cells in DIST_PROBLEMS if world > 1 \
            else DIST_PROBLEMS_ONE:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob = api.make_problem(rows, cols, vals, (m, n), r,
                                algorithm=algorithm, group=dist.group.WORLD)
        els = [prob.resolve_elision(el) for el in cells]
        orients = ("normal", "transpose") if "reuse" in els \
            and prob.alg.name in ("d15", "d25") else ("normal",)
        for o in orients:
            prob.plan(o)
        torch.cuda.synchronize()
        row = {"family": prob.alg.name, "c": prob.c,
               "plan_s": time.perf_counter() - t0, "cells": {}}
        want = costmodel.choose_algorithm(
            m=m, n=n, nnz=len(vals), r=r, p=world,
            families=costmodel.FAMILIES if algorithm == "auto"
            else (algorithm,))
        if (prob.alg.name, prob.c) != (want.family, want.c):
            raise AssertionError(f"{algorithm}: chose {prob.alg.name} "
                                 f"c={prob.c}, the cost model {want}")
        stacked = None
        if rank == 0 and world > 1:   # the same problem stacked on card 0
            t0 = time.perf_counter()
            stacked = api.make_problem(rows, cols, vals, (m, n), r,
                                       algorithm=prob.alg.name, c=prob.c,
                                       devices=[dev] * world)
            for o in orients:
                stacked.plan(o)
            torch.cuda.synchronize()
            row["stacked_plan_s"] = time.perf_counter() - t0
        # the counted pass: every cell once, launches on this rank
        ops.reset_launch_counts()
        outs, logs = {}, {}
        for el in els:
            outs[el] = prob.fusedmm(X, Y, elision=el)
            words_match(ck, prob, "fusedmm", el)     # == schedule_words
            logs[el] = prob.last_collectives.words()
        torch.cuda.synchronize()
        row["launches"] = ops.launch_counts()
        row["forms"] = ops.form_counts()
        need = ("fusedmm",) if world == 1 else \
            ("spmm", "sddmm", "fusedmm") if algorithm == "d15" \
            else ("spmm", "sddmm")
        for k in need:
            if row["launches"][k] <= 0:
                raise AssertionError(f"{algorithm}: {k} kernel not launched "
                                     f"on rank {rank}: {row['launches']}")
        for el in els:
            cell = {}
            blk, R = outs.pop(el)
            got = blk.gather()
            got_R = prob.grid.gather_stacked(R.raw)
            del blk, R
            if stacked is not None:
                # every rank's blocks == the stacked run's, bit for bit
                wo, wR = stacked.fusedmm(X, Y, elision=el)
                if tuple(wo.shape) != (m, r) or \
                        not bool(torch.isfinite(wo).all()):
                    raise AssertionError(f"{algorithm} {el}: stacked out")
                ck.equal(got, wo, f"{algorithm} {el} out == stacked")
                for a, b in zip(_leaves(got_R), _leaves(wR.raw)):
                    ck.equal(a, b, f"{algorithm} {el} R == stacked")
                if stacked.last_collectives.words() != logs[el]:
                    raise AssertionError(f"{algorithm} {el}: log != "
                                         f"stacked log")
                del wR
                ref, _ = stacked.fusedmm(X, Y, elision=el, backend="ref")
                cell["max_abs_err_vs_ref"] = ck.close(
                    wo, ref, 2e-3, f"{algorithm} {el} stacked vs ref")
                del wo, ref
                cell["stacked_ms"] = time_ms(
                    torch, lambda: stacked.fusedmm(X, Y, elision=el), reps)
            elif world == 1:   # held to the plain version instead
                ref, _ = prob.fusedmm(X, Y, elision=el, backend="ref")
                cell["max_abs_err_vs_ref"] = ck.close(
                    got, ref.gather(), 2e-3, f"{algorithm} {el} vs ref")
                del ref
            del got, got_R
            torch.cuda.empty_cache()
            cell["ms"] = time_ms(
                torch, lambda: prob.fusedmm(X, Y, elision=el), reps)
            cell["device"] = device_breakdown(
                torch, lambda: prob.fusedmm(X, Y, elision=el))
            # a serial pass with each collective timed
            fn, args, kwargs, _ = prob.alg._fusedmm_call(prob, X, Y, el,
                                                         None)
            over = {"overlap": False} if prob.alg.name in ("d15", "d25") \
                else {}
            coll = Timed(prob.grid)
            fn(*args, **kwargs, **over, coll=coll)
            cell["comm"] = comm_by_kind(coll)
            cell["comm_ms"] = sum(k["ms"] for k in cell["comm"].values())
            if prob.alg.name == "d15":
                # overlap == serial bit for bit; timed in turns
                a = _leaves(fn(*args, **kwargs, overlap=True))
                b = _leaves(fn(*args, **kwargs, overlap=False))
                for x, y in zip(a, b):
                    ck.equal(x, y, f"d15 {el} overlap == serial")
                del a, b
                t = [time_ms(torch, lambda ov=ov: fn(*args, **kwargs,
                                                     overlap=ov), reps)
                     for ov in (True, False, False, True)]
                cell["overlap_ms"] = [t[0], t[3]]
                cell["serial_ms"] = [t[1], t[2]]
            del fn, args, kwargs
            row["cells"][el] = cell
            torch.cuda.empty_cache()
        if algorithm == "d15" and world > 1:
            row["obs"] = dist_obs(torch, ck, prob, X, Y, world, reps)
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        report["problems"][algorithm] = row
        del prob, stacked
        torch.cuda.empty_cache()
    if world > 1:
        report["sampled_loss"] = dist_sampled_loss(
            torch, dist, ck, rank, world, rows, cols, vals, m, r, reps)
        del rows, cols, vals, X, Y
        torch.cuda.empty_cache()
        report["rmat"] = dist_rmat(torch, dist, ck, rank, world,
                                   comm_scale, reps, Timed)
        report["faults"] = dist_faults(torch, dist, ck, rank, world, scale)


def dist_obs(torch, ck, prob, X, Y, world, reps):
    """The obs cell on the cards: d15 "fused" traced ``reps`` times back
    to back on every rank (drift 1.0 on each round; the rounds' device
    ms, and per collective kind the spans' device ms of all rounds but
    the first, which also holds the ranks' skew on arrival), every
    rank's log of the last call gathered (``all_gather_object`` over
    NCCL) and the rendezvous simulation drained; then, with one rank's
    copy of the logs skipping a collective, the simulation must
    deadlock."""
    from repro_torch import obs
    from repro_torch.analysis import conformance
    t0 = time.perf_counter()
    tr = obs.Tracer()
    with obs.trace(tr):
        for _ in range(reps):
            prob.fusedmm(X, Y, elision="fused")
    rounds = tr.rounds
    if len(rounds) != reps:
        raise AssertionError(f"dist obs: {len(rounds)} rounds for {reps}")
    for rnd in rounds:
        check_spans(ck, prob, rnd, "dist obs")
        if rnd.drift != 1.0:
            raise AssertionError(f"dist obs: drift {rnd.drift} on rank "
                                 f"{prob.grid.rank}")
    logs = conformance.gather_logs(prob.grid, prob.last_collectives.log)
    counts = [len(v) for v in logs.values()]
    drained = conformance.simulate_rendezvous(
        conformance.rank_programs_from_logs(logs, world))
    if not drained["ok"]:
        raise AssertionError(f"dist obs: rendezvous stuck {drained}")
    logs[world - 1] = logs[world - 1][1:]
    broken = conformance.simulate_rendezvous(
        conformance.rank_programs_from_logs(logs, world))
    if broken["ok"]:
        raise AssertionError("dist obs: a skipped collective drained")
    ck.n += 3
    return {"drifts": [r.drift for r in rounds],
            "round_ms": [r.dur * 1e3 for r in rounds],
            "events": [[e.point, e.phase, e.kind, e.moves, e.device_ms]
                       for e in rounds[-1].events if e.moves],
            "comm": spans_by_kind(rounds[1:]),
            "collectives": counts,
            "rendezvous_fired": drained["fired"],
            "seconds": time.perf_counter() - t0}


#: the R-MAT problems of the four-card comm="sparse" cells: "auto"'s
#: family, c and cell, and d15 (the cost model's c) "fused"
DIST_RMAT = [("auto", None), ("d15", "fused")]


def dist_rmat(torch, dist, ck, rank, world, scale, reps, Timed):
    """The comm="sparse" cells on the cards: R-MAT 2^scale (each rank
    draws it), one rank a card, under the three wires.  "auto"'s cell:
    every rank's blocks == the stacked run's on card 0 bit for bit
    (bf16 too), its log the stacked log; both cells: sparse == dense bit
    for bit, bf16 within BF16_TOL, ms, the device split, and each
    collective kind's ms and GB/s in a serial pass (ranks lined up), with
    the share of communication time pruning saves."""
    from repro_torch.core import api
    from repro_torch.kernels import ops
    dev = torch.device("cuda", rank)
    r = 128
    rows, cols, vals, X, Y, gen_s = rmat_problem(torch, scale, r,
                                                  RMAT_SEED, PERMUTE_SEED)
    m = 1 << scale
    report = {"m": m, "nnz": int(len(vals)), "rmat_gen_s": gen_s,
              "permuted": True, "cells": {}}
    for algorithm, cell in DIST_RMAT:
        rows_out, base = {}, None
        for name, comm, compress in WIRES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            prob = api.make_problem(rows, cols, vals, (m, m), r,
                                    algorithm=algorithm, comm=comm,
                                    compress=compress,
                                    group=dist.group.WORLD)
            el = cell or prob.resolve_elision("auto")
            prob.plan("transpose" if el == "reuse"
                      and prob.alg.name in ("d15", "d25") else "normal")
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            what = f"{algorithm} {el} {name}"
            ops.reset_launch_counts()
            blk, R = prob.fusedmm(X, Y, elision=el)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            log = prob.last_collectives.words()
            got = (blk.gather(), *_leaves(prob.grid.gather_stacked(R.raw)))
            del blk, R
            if algorithm == "auto" and rank == 0:
                stacked = api.make_problem(
                    rows, cols, vals, (m, m), r, algorithm=prob.alg.name,
                    c=prob.c, comm=comm, compress=compress,
                    devices=[dev] * world)
                wo, wR = stacked.fusedmm(X, Y, elision=el)
                ck.equal_all(got, (wo, *_leaves(wR.raw)),
                             f"{what} == stacked")
                if stacked.last_collectives.words() != log:
                    raise AssertionError(f"{what}: log != stacked log")
                del stacked, wo, wR
            if base is None:
                base, err = got, 0.0
            elif compress is None:
                ck.equal_all(got, base, f"{what} == dense")
                err = 0.0
            else:
                err = _bf16_err(torch, got, base, what)
            del got
            torch.cuda.empty_cache()
            ms = time_ms(torch, lambda: prob.fusedmm(X, Y, elision=el), reps)
            split = device_breakdown(
                torch, lambda: prob.fusedmm(X, Y, elision=el))
            fn, args, kwargs, _ = prob.alg._fusedmm_call(prob, X, Y, el,
                                                         None)
            over = {"overlap": False} if prob.alg.name in ("d15", "d25") \
                else {}
            coll = Timed(prob.grid)
            fn(*args, **kwargs, **over, coll=coll)
            by_kind = comm_by_kind(coll)
            rows_out[name] = {
                "family": prob.alg.name, "c": prob.c, "cell": el,
                "plan_s": plan_s, "launches": launches,
                "words": sum(w for _, w in log), "ms": ms, "device": split,
                "comm": by_kind,
                "comm_ms": sum(k["ms"] for k in by_kind.values()),
                "bf16_err": err,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del prob, fn, args, kwargs
        dense_ms = rows_out["dense"]["comm_ms"]
        for name in ("sparse", "bf16"):
            rows_out[name]["comm_saved"] = (
                1 - rows_out[name]["comm_ms"] / dense_ms if dense_ms
                else None)
        report["cells"][algorithm] = rows_out
        del base
    return report


def dist_sampled_loss(torch, dist, ck, rank, world, rows, cols, vals, m, r,
                      reps):
    """One sampled-loss step (apps/als.py) on each rank over the group,
    on the "auto" problem of unit values: each rank's gradients (global,
    as core/grads returns them under a group) must equal the stacked
    run's on card 0, broadcast from rank 0, bit for bit."""
    from repro_torch.apps import als
    from repro_torch.core import api
    ones = np.ones(len(vals), np.float32)
    targets = torch.from_numpy(np.abs(vals) + 0.5).cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    X0 = torch.randn((m, r), generator=g, device="cuda") * 0.1
    Y0 = torch.randn((m, r), generator=g, device="cuda") * 0.1

    def grads_on(prob):
        Xl, Yl = X0.clone().requires_grad_(), Y0.clone().requires_grad_()
        loss = als.sampled_loss(prob, Xl, Yl, targets, 1e-4, api.Session())
        return torch.autograd.grad(loss, (Xl, Yl))

    prob = api.make_problem(rows, cols, ones, (m, m), r,
                            group=dist.group.WORLD)
    got = grads_on(prob)
    want = [torch.empty_like(t) for t in got]
    if rank == 0:
        stacked = api.make_problem(rows, cols, ones, (m, m), r,
                                   algorithm=prob.alg.name, c=prob.c,
                                   devices=[got[0].device] * world)
        want = list(grads_on(stacked))
        del stacked
    for t in want:
        dist.broadcast(t, src=0)
    for a, b, name in zip(got, want, ("dX", "dY")):
        ck.equal(a, b, f"sampled-loss {name} == stacked, rank {rank}")
    del want
    torch.cuda.empty_cache()
    return {"family": prob.alg.name, "c": prob.c,
            "ms": time_ms(torch, lambda: grads_on(prob), reps)}


#: the fault cells of the dist phase: d15's cell and the rank it loses
DIST_FAULT_CELL, DIST_FAULT_LOST = ("d15", "fused"), 3


def dist_faults(torch, dist, ck, rank, world, scale):
    """The dist phase's fault cells on integer data (see the module doc):
    a TransientFault retried on the same group, then a DeviceLost at
    rank DIST_FAULT_LOST; returns this rank's record (``outcome``: the
    survivors' "recovered", the others' "retired")."""
    from repro_torch.core import api
    from repro_torch.distributed import faults
    dev = torch.device("cuda", rank)
    m, r = 1 << scale, 128
    rows, cols, vals, X, Y = integer_problem(torch, m, 16, r, 0)
    family, el = DIST_FAULT_CELL
    t0 = time.perf_counter()
    prob = api.make_problem(rows, cols, vals, (m, m), r, algorithm=family,
                            group=dist.group.WORLD)
    blk, R = prob.fusedmm(X, Y, elision=el)
    base_out = blk.gather()
    base_R = _leaves(prob.grid.gather_stacked(R.raw))
    rec = {"family": family, "c": prob.c, "elision": el,
           "plan_s": time.perf_counter() - t0}

    # a transient fault: the same group retries, bit for bit
    plan = faults.FaultPlan.scripted(faults.FaultSpec(op="fusedmm", rank=1,
                                                      round=0))
    with faults.inject(plan) as ctl:
        ep = api.ElasticProblem(prob, session=api.Session())
        (b2, R2), rec["transient_ms"] = timed_call(
            torch, lambda: ep.fusedmm(X, Y, elision=el))
    if len(ctl.fired) != 1 or len(ep.recoveries) != 1:
        raise AssertionError(f"dist faults: transient fired {ctl.fired}")
    ck.equal(b2.local, blk.local, "dist transient: block == fault-free")
    for x, y in zip(_leaves(R2.raw), _leaves(R.raw)):
        ck.equal(x, y, "dist transient: R == fault-free")
    del b2, R2, blk, R, ep

    # a lost rank: every process takes part in the degraded group
    degrade_s = []
    plan = faults.FaultPlan.scripted(faults.FaultSpec(
        op="fusedmm", rank=DIST_FAULT_LOST, round=0, kind="device_lost"))
    ep = api.ElasticProblem(prob)
    t0 = time.perf_counter()
    try:
        with faults.inject(plan), \
                patched(api, "degrade", seconds_of(degrade_s)):
            (out, R2), first_ms = timed_call(
                torch, lambda: ep.fusedmm(X, Y, elision=el))
    except api.RankRetired as e:
        rec.update(outcome="retired", p_after=e.p, lost_rank=e.lost_rank,
                   replan_host_s=degrade_s[0],
                   leave_s=time.perf_counter() - t0)
        return rec
    new = ep.problem
    got = out.gather()
    ck.equal(got, base_out, "dist degraded: out == fault-free p = 4")
    rec.update(outcome="recovered", p_after=new.p, family_after=new.alg.name,
               c_after=new.c, replan_host_s=degrade_s[0],
               first_call_ms=first_ms,
               ms=time_ms(torch, lambda: new.fusedmm(X, Y, elision=el), 3))
    got_R = _leaves(new.grid.gather_stacked(R2.raw))
    del out, R2
    if rank == 0:   # the stacked run of the degraded p on card 0
        stacked = api.make_problem(rows, cols, vals, (m, m), r,
                                   algorithm=new.alg.name, c=new.c,
                                   devices=[dev] * new.p)
        wo, wR = stacked.fusedmm(X, Y, elision=el)
        ck.equal(got, wo, "dist degraded: out == stacked")
        for x, y in zip(got_R, _leaves(wR.raw)):
            ck.equal(x, y, "dist degraded: R == stacked")
        del stacked, wo, wR
    del got, got_R, base_out, base_R, new, ep, prob
    torch.cuda.empty_cache()
    return rec


#: the dist phase's serving cells: cell A's traffic, (engine, clients a
#: burst); the ranks its two faults lose (4 -> 2 -> 1); the rows of the
#: world-1 cell (cut from 2^22 to keep the one-card script's time)
DIST_SERVE_TRAFFIC = [("batched", 1), ("batched", 8), ("batched", 32),
                      ("solo", 1), ("solo", 8)]
DIST_SERVE_LOST = (3, 1)
DIST_SERVE_ONE_SCALE = 20


class LaunchWindows:
    """The kernel launches of one cell's served segments on this rank.
    A window sets every count to 0 as it opens and adds the counts to
    the cell's sums as it closes; ``paused()`` inside one leaves out
    what runs in it (the front end's stacked run beside the group's),
    so the sums count the served path alone."""

    def __init__(self):
        self.launches, self.forms = {}, {}

    def _add(self):
        from repro_torch.kernels import ops
        for k, v in ops.launch_counts().items():
            self.launches[k] = self.launches.get(k, 0) + v
        for k, f in ops.form_counts().items():
            mine = self.forms.setdefault(k, {})
            for form, v in f.items():
                mine[form] = mine.get(form, 0) + v

    @contextlib.contextmanager
    def __call__(self):
        from repro_torch.kernels import ops
        ops.reset_launch_counts()
        try:
            yield
        finally:
            self._add()

    @contextlib.contextmanager
    def paused(self):
        from repro_torch.kernels import ops
        self._add()
        try:
            yield
        finally:
            ops.reset_launch_counts()

    def held(self, kernels, what):
        """The sums, after failing if a kernel of ``kernels`` never
        launched in a window."""
        for k in kernels:
            if self.launches.get(k, 0) <= 0:
                raise AssertionError(f"{what}: {k} kernel not launched: "
                                     f"{self.launches}")
        return {"launches": self.launches, "forms": self.forms}


def served(eng, fn, win, plan=None):
    """One served segment on a group, counted in the window ``win`` on
    every rank: ``fn`` (the front end's submissions and ticks) then
    ``stop()`` on the front end, ``follow()`` on every other rank;
    ``plan`` armed on every rank.  (fn's result or None, the fault
    controller.)"""
    from repro_torch.distributed import faults
    with (faults.inject(plan) if plan is not None
          else contextlib.nullcontext()) as ctl, win():
        if eng.front_end:
            out = fn()
            eng.stop()
        else:
            out = None
            eng.follow()
    return out, ctl


@contextlib.contextmanager
def recording(eng, keep):
    """Inside the block, append each tick's report of ``eng`` (the front
    end's), without its tickets, to ``keep``.  The wrapper leaves with
    the block: an engine attribute holding its own bound method would tie
    the engine, its pool and their device memory into a reference cycle
    that only the collector frees."""
    orig = eng.tick

    def tick():
        rep = orig()
        keep.append({k: v for k, v in rep.items() if k != "tickets"})
        return rep

    eng.tick = tick
    try:
        yield keep
    finally:
        del eng.tick


def gather_seconds(torch, spent):
    """A ``patched`` wrapper of ``_Grid.gather_stacked`` recording each
    outermost call's seconds, the card synchronised before and after
    (so a gather holds its wait for the slowest peer)."""
    def wrap(orig):
        depth = [0]

        def spy(self, x):
            if depth[0]:
                return orig(self, x)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(self, x)
            finally:
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t0)
                depth[0] -= 1
        return spy
    return wrap


def tick_split(torch, eng, fn):
    """Run ``fn`` (submits and ticks once) with the result gathers timed:
    the tick's report (ms: wall, record broadcast, gather) and fn's
    result."""
    from repro_torch.core import grid as grid_mod
    spent, keep = [], []
    with recording(eng, keep), patched(grid_mod._Grid, "gather_stacked",
                                       gather_seconds(torch, spent)):
        out = fn()
    rep = keep[-1]
    return {"requests": rep["requests"], "rounds": rep["rounds"],
            "tick_ms": rep["wall"] * 1e3,
            "broadcast_ms": rep.get("broadcast_ms"),
            "record_bytes": rep.get("record_bytes"),
            "gather_ms": sum(spent) * 1e3}, out


def score_figures(torch, ck, eng, dep, catalog, want, conc, tag):
    """On the front end: the open-loop score traffic at ``conc`` clients
    a burst (a replay of 2 bursts to warm, then SERVE_BURSTS measured:
    p50/p99, requests a second, each tick's wall and record), every
    answer against the exact dots; then 3 one-burst ticks with their
    gathers timed.  Returns (figures, the burst ticks' answers by
    catalog index, their (requests, rounds))."""
    from repro_torch import serving
    serving.replay_trace(eng, score_trace(dep, conc, 2, catalog)[0])
    trace, order = score_trace(dep, conc, SERVE_BURSTS, catalog)
    with recording(eng, []) as keep:
        res = serving.replay_trace(eng, trace)
    for t, k in zip(res["tickets"], order):
        ck.equal(t.result(), want[k], f"{tag} c{conc} score == exact")
    fig = {"concurrency": conc, "served": res["served"],
           "p50_ms": res["p50"] * 1e3, "p99_ms": res["p99"] * 1e3,
           "requests_per_s": res["throughput"], "ticks": len(keep),
           "tick_ms": [k["wall"] * 1e3 for k in keep],
           "broadcast_ms": [k.get("broadcast_ms") for k in keep],
           "record_bytes": [k.get("record_bytes") for k in keep]}
    answers, reports, splits = [], [], []
    _, order = score_trace(dep, conc, 1, catalog)
    for _ in range(3):
        split, rep = tick_split(torch, eng, lambda: one_burst(
            serving, dep, eng, conc, catalog))
        splits.append(split)
        reports.append((rep["requests"], rep["rounds"]))
        answers.append([(k, t.result()) for k, t in zip(order,
                                                      rep["tickets"])])
    fig["split"] = splits
    return fig, answers, reports


def stamper(tag):
    """A log of elapsed seconds at each named step (one line each)."""
    t0 = time.perf_counter()

    def stamp(what):
        log(f"{tag} +{time.perf_counter() - t0:.1f} s: {what}")
    return stamp


def dist_serving(torch, dist, ck, rank, world, scale):
    """The dist phase's serving cell A on the group (see the module
    doc); this rank's record.  The front end (rank 0) submits, ticks
    and checks; the other ranks follow its tick records."""
    import gc
    from repro_torch import serving
    from repro_torch.apps import als
    from repro_torch.core import api
    from repro_torch.distributed import faults
    from repro_torch.serving import pool as pool_mod
    group = dist.group.WORLD
    front = rank == 0
    dev = torch.device("cuda", rank)
    m, r = 1 << scale, 128
    stamp = stamper(f"dist serving rank {rank}")
    t0 = time.perf_counter()
    rows, cols, vals, U, V = integer_problem(torch, m, 16, r, 0)
    rec = {"m": m, "r": r, "nnz": int(len(vals)),
           "gen_s": time.perf_counter() - t0}
    stamp("data drawn")
    pool = serving.SessionPool(capacity=2)
    digest_s = []
    with patched(pool_mod, "content_key", seconds_of(digest_s)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dep = als.deploy_factors(pool, rows, cols, vals, (m, m), U, V,
                                 group=group)
        torch.cuda.synchronize()
    rec["deploy"] = {"seconds": time.perf_counter() - t0,
                     "digest_s": digest_s[0], "family": dep.problem.alg.name,
                     "c": dep.problem.c, "p": dep.problem.p}
    stamp("deployed")
    win = LaunchWindows()
    engines = {"batched": serving.ServingEngine(pool, max_batch=64,
                                                group=group),
               "solo": serving.ServingEngine(pool, max_batch=64,
                                             batching=False,
                                             use_session=False, group=group)}
    eng = engines["batched"]
    rng = np.random.default_rng(3)
    catalog = [(rng.integers(0, m, SERVE_QUERY),
                rng.integers(0, m, SERVE_QUERY))
               for _ in range(SERVE_CATALOG)]
    want, st = None, {}     # st: the stacked run (front end only)
    if front:
        want = [exact_scores(torch, U, V, qr, qc) for qr, qc in catalog]
        # the same deployment stacked at p = world on card 0 (the same
        # content, so the group's key)
        pool4 = serving.SessionPool(capacity=2)
        with patched(pool_mod, "content_key",
                     lambda orig: lambda *a, **k: dep.key):
            st["dep"] = als.deploy_factors(pool4, rows, cols, vals, (m, m),
                                           U, V, devices=[dev] * world)
        st["batched"] = serving.ServingEngine(pool4, max_batch=64)
        st["solo"] = serving.ServingEngine(pool4, max_batch=64,
                                           batching=False, use_session=False)
        del pool4
        rows_t = torch.from_numpy(rows).to(dev).long()
        cols_t = torch.from_numpy(cols).to(dev).long()
        vals_t = torch.from_numpy(vals).to(dev).double()
        stamp("stacked run deployed")
    del U, V            # the deployments hold their own copies
    torch.cuda.empty_cache()
    seen = {}       # catalog index -> the stacked run's answer

    def same_as_stacked(k, got, what):
        ck.equal(got, want[k], f"{what} == exact")
        if k in seen:
            ck.equal(got, seen[k], f"{what} == stacked p = {world}")

    # score traffic: batched and solo, beside the stacked run's
    def traffic(mode, conc):
        fig, ans, reps = score_figures(torch, ck, engines[mode], dep,
                                       catalog, want, conc, "dist serving")
        with win.paused():
            fig4, ans4, reps4 = score_figures(torch, ck, st[mode],
                                              st["dep"], catalog, want,
                                              conc, "dist serving stacked")
        if reps != reps4:
            raise AssertionError(f"dist serving {mode} c{conc}: tick "
                                 f"reports {reps} != stacked {reps4}")
        for a, b in zip(ans, ans4):
            for (k, x), (_, y) in zip(a, b):
                seen.setdefault(k, y)
                same_as_stacked(k, x, f"dist serving {mode} c{conc}")
        log(f"dist serving p={world} {mode} c{conc}: p50 "
            f"{fig['p50_ms']:.2f} ms, p99 {fig['p99_ms']:.2f} ms, "
            f"{fig['requests_per_s']:.0f} req/s (stacked p50 "
            f"{fig4['p50_ms']:.2f} ms)")
        return {"mode": mode, "cards": fig, "stacked": fig4}

    rec["scores"] = []
    for mode, conc in DIST_SERVE_TRAFFIC:
        out, _ = served(engines[mode], lambda: traffic(mode, conc), win)
        rec["scores"].append(out)
        stamp(f"scores {mode} c{conc}")

    # the 8 lookups in one tick, beside the stacked run's
    def lookups(tag, Ws):
        split4 = None
        if st:
            # the stacked run first, then freed: its deployment and the
            # group's (m, 512) rounds would not fit on card 0 together.
            # Its Session's replicas (U, V, then the round's operand) go
            # before and after its tick, to keep card 0's peak down
            with win.paused():
                e4 = st["batched"]
                t4 = [als.lookup_embeddings(e4, st["dep"], W) for W in Ws]
                st["dep"].session.clear()
                rep4 = e4.tick()
                st["dep"].session.clear()
                stamp(f"{tag}: the stacked run ticked")
                for W, t in zip(Ws, t4):
                    ck.equal(t.result(), exact_spmm(torch, rows_t, cols_t,
                                                    vals_t, W, m),
                             f"dist {tag} stacked p = {world} == exact")
                split4 = {"requests": rep4["requests"],
                          "rounds": rep4["rounds"],
                          "tick_ms": rep4["wall"] * 1e3}
                del t4, rep4, e4
                st.clear()
                gc.collect()
                torch.cuda.empty_cache()

        def tick():
            tickets = [als.lookup_embeddings(eng, dep, W) for W in Ws]
            eng.tick()
            return tickets

        split, tickets = tick_split(torch, eng, tick)
        stamp(f"{tag}: ticked")
        # held to the exact products, as the stacked run's were: the two
        # runs' lookups are equal bit for bit
        for W, t in zip(Ws, tickets):
            ck.equal(t.result(), exact_spmm(torch, rows_t, cols_t, vals_t,
                                            W, m),
                     f"dist {tag} w={W.shape[1]} == exact")
        if split4 is not None:
            if (split4["requests"], split4["rounds"]) != (split["requests"],
                                                          split["rounds"]):
                raise AssertionError(f"dist lookups: {split} != {split4}")
            split["stacked"] = split4
        split["record_gb_per_s"] = (split["record_bytes"] / 1e6
                                    / split["broadcast_ms"])
        split["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del tickets
        torch.cuda.empty_cache()
        return split

    def lookup_weights(widths, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randint(-3, 4, (m, w), generator=g,
                              device=dev).float() for w in widths]

    # every rank drops the Session's replicas of U and V at once (the
    # next score tick misses them again on every rank): 8 GiB a card of
    # headroom for the (m, 512) round
    dep.session.clear()
    torch.cuda.empty_cache()
    rec["lookups"], _ = served(eng, lambda: lookups(
        "lookups", lookup_weights(LOOKUP_WIDTHS, 5)), win)
    stamp("lookups")

    # the losses: rank 3 in a score tick, then rank 1 in a lookup tick
    def lose(op):
        if op == "sddmm":
            tickets = [als.predict_scores(eng, dep, *catalog[k])
                       for k in range(SERVE_CATALOG)]
            rep = eng.tick()
            for k, t in enumerate(tickets):
                same_as_stacked(k, t.result(), "dist serving after a loss")
            return {"tick_ms": rep["wall"] * 1e3}
        W2 = lookup_weights((16,), 6)
        return lookups("lookup after a loss", W2)

    rec["losses"] = []
    for op, lost in zip(("sddmm", "spmm"), DIST_SERVE_LOST):
        plan = faults.FaultPlan.scripted(faults.FaultSpec(
            op=op, kind="device_lost", rank=lost, round=0))
        held = dep.retired is None
        p_before = dep.problem.p
        degrade_s = []
        with patched(api, "degrade", seconds_of(degrade_s)):
            out, ctl = served(eng, lambda: lose(op), win, plan)
        ev = {"op": op, "lost_rank": lost, "fired": len(ctl.fired),
              "replan_host_s": degrade_s[0] if degrade_s else None}
        if not held:
            ev["outcome"] = "away"
        elif dep.retired is not None:
            ev.update(outcome="retired", p_after=dep.retired.p)
        else:
            ev.update(outcome="recovered", p=p_before, p_after=dep.problem.p,
                      family_after=dep.problem.alg.name,
                      c_after=dep.problem.c)
            if dep.problem.p >= p_before:
                raise AssertionError(f"dist serving: {op} loss left p "
                                     f"{p_before}")
        if out is not None:
            ev["first_tick"] = out
        rec["losses"].append(ev)
        stamp(f"loss in {op}: {ev['outcome']}")
        if front:
            log(f"dist serving: DeviceLost({lost}) in {op}: p {p_before} -> "
                f"{dep.problem.p}, re-plan {ev['replan_host_s']:.3f} host "
                f"s, first tick {out['tick_ms']:.0f} ms")

    # the traffic again on the degraded group, then the Session re-warmed
    def again():
        figs = [score_figures(torch, ck, eng, dep, catalog, want, conc,
                              "dist serving degraded")[0]
                for conc in SERVE_CONCURRENCY]
        steady = []
        for _ in range(2):
            tickets = [als.predict_scores(eng, dep, *catalog[k])
                       for k in range(SERVE_CATALOG)]
            wall = eng.tick()["wall"]
            for k, t in enumerate(tickets):
                same_as_stacked(k, t.result(), "dist serving degraded")
            steady.append({"tick_ms": wall * 1e3,
                           "session": dep.session.stats()})
        if steady[1]["session"]["hits"] <= steady[0]["session"]["hits"]:
            raise AssertionError(f"dist serving: no Session hit after "
                                 f"re-warming {steady}")
        return {"scores": figs, "steady": steady,
                "lookup": lookups("lookup degraded",
                                  lookup_weights((16,), 6))}

    rec["degraded"], _ = served(eng, again, win)
    stamp("degraded traffic")
    rec["pool"] = pool.stats()
    rec.update(win.held(("sddmm", "spmm"), f"dist serving rank {rank}"))
    del dep, engines, eng, pool
    if front:
        del rows_t, cols_t, vals_t, want
    torch.cuda.empty_cache()
    return rec


def dist_serving_gat(torch, dist, ck, rank, world, scale):
    """The dist phase's serving cell B: GAT inference at 2^scale nodes
    on the group, each client's rows bit for bit gat_layer_distributed's
    on the same group and within 2e-3 of its plain version."""
    import torch.nn.functional as F
    from repro_torch import serving
    from repro_torch.apps import gat
    from repro_torch.core import api
    from repro_torch.kernels import ops
    group = dist.group.WORLD
    dev = torch.device("cuda", rank)
    m, d = 1 << scale, 128
    stamp = stamper(f"dist serving GAT rank {rank}")
    rows, cols = gat_graph_on_card(torch, m, 16, 0)
    g = torch.Generator(device="cuda").manual_seed(2)
    H = torch.randn((m, d), generator=g, device="cuda")
    params = gat.init_gat_layer(
        torch.Generator(device="cuda").manual_seed(0), d, d)
    rec = {"m": m, "d": d, "nnz": int(len(rows))}
    pool = serving.SessionPool(capacity=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dep = gat.gat_deploy_layer(pool, rows, cols, m, H, params, group=group)
    torch.cuda.synchronize()
    rec["deploy"] = {"seconds": time.perf_counter() - t0,
                     "family": dep.problem.alg.name, "c": dep.problem.c}
    stamp("deployed")
    graphP = api.make_problem(rows, cols, np.ones(len(rows), np.float32),
                              (m, m), d, group=group)
    full = gat.gat_layer_distributed(graphP, H, params)
    ops.set_default_backend("ref")
    try:
        plain = gat.gat_layer_distributed(graphP, H, params)
    finally:
        ops.set_default_backend("cuda")
    stamp("distributed layer and its plain version")
    eng = serving.ServingEngine(pool, max_batch=64, group=group)

    def queries():
        rng = np.random.default_rng(4)
        ticks, worst = [], 0.0
        for i in range(2 + GAT_TICKS):  # the first packs; the last splits
            clients = [np.sort(rng.choice(m, GAT_QUERY, replace=False))
                       for _ in range(GAT_CLIENTS)]

            def query():
                t0 = time.perf_counter()
                scores = [gat.gat_submit_scores(eng, dep, ids)[0]
                          for ids in clients]
                rep1 = eng.tick()
                aggs = [gat.gat_submit_aggregate(eng, dep, ids, t.result())
                        for ids, t in zip(clients, scores)]
                rep2 = eng.tick()
                torch.cuda.synchronize()
                return rep1, rep2, aggs, time.perf_counter() - t0

            split = None
            if i == 1 + GAT_TICKS:
                split, (rep1, rep2, aggs, wall) = tick_split(torch, eng,
                                                             query)
            else:
                rep1, rep2, aggs, wall = query()
            for ids, t in zip(clients, aggs):
                idx = torch.from_numpy(ids).to(dev)
                got = F.elu(t.result())[idx]
                ck.equal(got, full[idx], "dist served GAT rows == "
                         "distributed layer")
                worst = max(worst, ck.close(got, plain[idx], 2e-3,
                                            "dist served GAT rows vs plain"))
            ticks.append({
                "score_tick_ms": rep1["wall"] * 1e3,
                "aggregate_tick_ms": rep2["wall"] * 1e3,
                "broadcast_ms": [rep1["broadcast_ms"], rep2["broadcast_ms"]],
                "record_bytes": [rep1["record_bytes"], rep2["record_bytes"]],
                "rounds": [rep1["rounds"], rep2["rounds"]],
                "query_ms": wall * 1e3, "aggregate_split": split})
            del aggs
        qms = sorted(t["query_ms"] for t in ticks[1:-1])
        log(f"dist serving GAT p={world}: query ticks "
            f"{qms[0]:.1f}-{qms[-1]:.1f} ms")
        return {"ticks": ticks, "p50_ms": float(np.percentile(qms, 50)),
                "p99_ms": float(np.percentile(qms, 99)),
                "requests_per_s": GAT_CLIENTS * len(qms) / (sum(qms) / 1e3),
                "max_abs_err_vs_plain": worst}

    win = LaunchWindows()
    rec["queries"], _ = served(eng, queries, win)
    stamp("queries")
    rec["session"] = dep.session.stats()
    rec.update(win.held(("sddmm", "spmm"),
                        f"dist serving GAT rank {rank}"))
    del dep, eng, pool, graphP, full, plain, H
    torch.cuda.empty_cache()
    return rec


def dist_serving_one(torch, dist, ck, scale):
    """World 1: cell A's score traffic at 1 and 8 clients at 2^scale rows
    through a front end with no follower, == the same traffic on an
    engine without a group, bit for bit, answers and tick reports."""
    from repro_torch import serving
    from repro_torch.apps import als
    from repro_torch.serving import pool as pool_mod
    dev = torch.device("cuda", 0)
    m, r = 1 << scale, 128
    rows, cols, vals, U, V = integer_problem(torch, m, 16, r, 0)
    pool = serving.SessionPool(capacity=1)
    t0 = time.perf_counter()
    dep = als.deploy_factors(pool, rows, cols, vals, (m, m), U, V,
                             group=dist.group.WORLD)
    rec = {"m": m, "deploy_s": time.perf_counter() - t0,
           "family": dep.problem.alg.name}
    pool1 = serving.SessionPool(capacity=1)
    with patched(pool_mod, "content_key",
                 lambda orig: lambda *a, **k: dep.key):
        dep1 = als.deploy_factors(pool1, rows, cols, vals, (m, m), U, V,
                                  devices=[dev])
    eng = serving.ServingEngine(pool, max_batch=64, group=dist.group.WORLD)
    plain = serving.ServingEngine(pool1, max_batch=64)
    rng = np.random.default_rng(3)
    catalog = [(rng.integers(0, m, SERVE_QUERY),
                rng.integers(0, m, SERVE_QUERY))
               for _ in range(SERVE_CATALOG)]
    want = [exact_scores(torch, U, V, qr, qc) for qr, qc in catalog]
    rec["scores"] = []
    win = LaunchWindows()
    for conc in (1, 8):
        with win():
            fig, ans, reps = score_figures(torch, ck, eng, dep, catalog,
                                           want, conc, "world-1 serving")
        fig1, ans1, reps1 = score_figures(torch, ck, plain, dep1, catalog,
                                          want, conc, "world-1 no group")
        if reps != reps1:
            raise AssertionError(f"world-1 serving c{conc}: {reps} != "
                                 f"{reps1}")
        for a, b in zip(ans, ans1):
            for (_, x), (_, y) in zip(a, b):
                ck.equal(x, y, f"world-1 serving c{conc} == no group")
        rec["scores"].append({"group": fig, "no_group": fig1})
    eng.stop()
    rec.update(win.held(("sddmm",), "world-1 serving"))
    del dep, dep1, eng, plain, pool, pool1, U, V
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# the LM train step over the group
# ---------------------------------------------------------------------------

#: the four-card train cell: global batch, sequence, steps before and
#: after remesh(DIST_TRAIN_REMESH, 1)
DIST_TRAIN_BATCH, DIST_TRAIN_SEQ, DIST_TRAIN_STEPS = 8, 512, 3
DIST_TRAIN_REMESH = 2
DIST_TRAIN_TOL = 1e-4   # step 0 against one card, loss and grad norm


def param_prints(torch, model):
    """(parameters, 2) int64: each parameter's float32 bits summed plain
    and weighted by position, to compare replicas across ranks."""
    out = []
    for p in model.parameters():
        w = p.detach().reshape(-1).view(torch.int32).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append(torch.stack([w.sum(), (w * pos).sum()]))
        del w, pos
    return torch.stack(out)


def _same_on_ranks(torch, dist, x, group, what):
    """``x`` equal bit for bit on every rank of ``group``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    if not all(torch.equal(q, parts[0]) for q in parts):
        raise AssertionError(f"{what}: the ranks differ")


def _llama_cut(layers):
    import dataclasses
    from repro_torch.config import get_config
    full = get_config("llama3.2-1b")
    (sb, _), = full.segments
    return dataclasses.replace(full, name=f"llama3.2-1b-{layers}l",
                               segments=((sb, layers),))


def dist_train_steps(torch, dist, cfg, mesh, model, state, steps, dev,
                     pcfg=None):
    """``steps`` train steps of ``cfg`` on this rank's rows of the global
    batch, every rank's parameters compared after each (those FSDP does
    not split); returns each step's metrics and ms (host clock, the card
    synchronised)."""
    import types
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.training import data as D
    from repro_torch.training import train_step as ts
    pcfg = pcfg or ParallelConfig(compute_dtype="float32")
    same = types.SimpleNamespace(parameters=lambda: iter(
        [p for p in model.parameters() if tpm.fsdp_dim(p) is None]))
    tcfg = TrainConfig(seq_len=DIST_TRAIN_SEQ, global_batch=DIST_TRAIN_BATCH,
                       steps=100)
    step, _, _ = ts.make_train_step(cfg, pcfg, tcfg, mesh)
    pipe = D.SyntheticLM(cfg.vocab, DIST_TRAIN_SEQ, DIST_TRAIN_BATCH)
    lo, hi = ts.data_rows(mesh, DIST_TRAIN_BATCH)
    out = []
    for i in steps:
        b = {k: torch.as_tensor(v).to(dev)
             for k, v in pipe.batch(i, lo, hi).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if mesh is not None and mesh.data_group is not None:
            _same_on_ranks(torch, dist, param_prints(torch, same),
                           mesh.data_group, f"dist train step {i} params")
        out.append(dict({k: float(v) for k, v in m.items()}, step=i, ms=ms,
                        rows=[lo, hi]))
    return out


@contextlib.contextmanager
def timed_sums(torch, rec):
    """``train_step.ordered_sum`` timed (the card synchronised around
    each call): its ms and float32 bytes into ``rec``."""
    from repro_torch.training import train_step as ts

    def wrap(orig):
        def call(tensors, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(tensors, group)
            torch.cuda.synchronize()
            rec.append(((time.perf_counter() - t0) * 1e3,
                        sum(t.numel() * t.element_size() for t in tensors)))
        return call
    with patched(ts, "ordered_sum", wrap):
        yield rec


def dist_train(torch, dist, ck, rank, world, out_dir):
    """The LM train step over the group.  World 1: one step of llama3.2-1b
    at full width (depth cut) with a group of one against none, bit for
    bit.  More: llama3.2-1b at full width and depth data-parallel over
    every rank, DIST_TRAIN_STEPS steps of one global batch (every rank's
    parameters equal bit for bit after each; the gradient sum's ms and
    GB/s), step 0 against one card; then remesh(2, 1) from a checkpoint,
    DIST_TRAIN_STEPS more steps (step == 2 * DIST_TRAIN_STEPS), the
    ranks left out raising api.RankRetired."""
    import dataclasses
    import gc
    from repro_torch.core.api import RankRetired
    from repro_torch.distributed.elastic import remesh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    dev = torch.device("cuda", rank)
    t0 = time.perf_counter()
    mesh = lmesh.make_local_mesh(device=dev)

    def fresh(cfg):
        g = torch.Generator(device=dev).manual_seed(0)
        model = M.init_params(cfg, g, device=dev)
        return model, opt.init_opt_state(model)

    if world == 1:
        cfg = _llama_cut(TRAIN_LM_CUT_LAYERS)
        one = dataclasses.replace(mesh, data_group=dist.new_group([0]))
        res = {}
        for name, m in (("group_of_one", one), ("none", None)):
            model, state = fresh(cfg)
            res[name] = (dist_train_steps(torch, dist, cfg, m, model, state,
                                          range(1), dev),
                         param_prints(torch, model))
            del model, state
        ck.equal(res["group_of_one"][1], res["none"][1],
                 "dist train: a group of one == none")
        for k in ("loss", "grad_norm"):
            if res["group_of_one"][0][0][k] != res["none"][0][0][k]:
                raise AssertionError(f"dist train: {k} differs")
        return {"cut": f"layers 16 -> {TRAIN_LM_CUT_LAYERS}",
                "steps": {k: v[0] for k, v in res.items()},
                "seconds": time.perf_counter() - t0}

    from repro_torch.config import get_config
    cfg = get_config("llama3.2-1b")
    model, state = fresh(cfg)
    sums = []
    with timed_sums(torch, sums):
        steps = dist_train_steps(torch, dist, cfg, mesh, model, state,
                                 range(DIST_TRAIN_STEPS), dev)
    ck.n += DIST_TRAIN_STEPS
    grad_sums = [(ms, nbytes) for ms, nbytes in sums if nbytes > 1 << 20]
    report = {"arch": cfg.name, "world": world, "steps": steps,
              "grad_sum": [{"ms": ms, "gb": nbytes / 1e9,
                            "gb_per_s_received": (world - 1) * nbytes
                            / ms / 1e6} for ms, nbytes in grad_sums]}
    ck_dir = pathlib.Path(out_dir) / "train_ckpt"
    if rank == 0:
        t1 = time.perf_counter()
        ckpt.save(str(ck_dir), DIST_TRAIN_STEPS,
                  ltrain.train_tree(model, state))
        report["save_s"] = time.perf_counter() - t1
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        # step 0 of the same global batch on one card
        model, state = fresh(cfg)
        alone = dist_train_steps(torch, dist, cfg, None, model, state,
                                 range(1), dev)[0]
        del model, state
        torch.cuda.empty_cache()
        for k in ("loss", "grad_norm"):
            want, got = alone[k], steps[0][k]
            if abs(got - want) > DIST_TRAIN_TOL * max(1.0, abs(want)):
                raise AssertionError(f"dist train step 0 {k}: {got} vs one "
                                     f"card {want}")
            ck.n += 1
        report["one_card_step0"] = alone
    dist.barrier()
    try:
        mesh2 = remesh(DIST_TRAIN_REMESH, 1, device=dev)
    except RankRetired as e:
        report["remesh"] = {"outcome": "retired", "p": e.p}
    else:
        t1 = time.perf_counter()
        model, state = fresh(cfg)
        ltrain.load_tree(model, state, ckpt.restore(
            str(ck_dir), DIST_TRAIN_STEPS, ltrain.train_tree(model, state)))
        restore_s = time.perf_counter() - t1
        after = dist_train_steps(torch, dist, cfg, mesh2, model, state,
                                 range(DIST_TRAIN_STEPS,
                                       2 * DIST_TRAIN_STEPS), dev)
        if int(state["step"]) != 2 * DIST_TRAIN_STEPS:
            raise AssertionError(f"dist train remesh: step "
                                 f"{int(state['step'])}")
        ck.n += 1 + DIST_TRAIN_STEPS
        report["remesh"] = {"outcome": "recovered", "p": DIST_TRAIN_REMESH,
                            "restore_s": restore_s, "steps": after,
                            "step": int(state["step"])}
        del model, state
    torch.cuda.empty_cache()
    report["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    report["seconds"] = time.perf_counter() - t0
    return report


#: the tensor-parallel cells: the cards, qwen3-4b's run through
#: launch.train.main, the llama remesh flow's meshes and steps a phase
DIST_TP_WORLD = 4
DIST_TP_SEQ, DIST_TP_BATCH, DIST_TP_STEPS = 512, 8, 4
DIST_TP_ELASTIC = ((2, 2), (2, 2), 3)   # (data, model), remesh(n, m), steps
DIST_TP_LOSS_TOL = 1e-5   # qwen3-4b's step 0 loss against one card, absolute
#: qwen3-4b's model-group sum operands: the residual stream's partial sums
#: (batch x seq x d, the largest) and a small one (d; both split on dim 0)
DIST_TP_SUM_SHAPES = {"residual": (8, 512, 2560), "norm_grad": (2560,)}
DIST_TP_SUM_REPS = 20
DIST_FSDP_FLOW_TOL = 1e-5   # (F2): each loss against the flow without FSDP


@contextlib.contextmanager
def timed_model_sums(torch, rec, when=None):
    """The model group's collectives (``tensor_parallel.TP``'s ordered
    sum, gather and reduce-scatter; FSDP's on the data group) timed, the
    card synchronised around each outermost call: (kind, ms, bytes of
    this rank's part, bytes it received) into ``rec``.  A call made
    inside another (a sum's reduce-scatter and gather) adds what it
    received to the outer one's record.  ``when``: time only while it
    returns True (the other calls run untouched)."""
    from repro_torch.distributed import tensor_parallel as tpm
    inner = []

    def wrap(kind):
        def outer(orig):
            def call(self, x, *a):
                if when is not None and not when():
                    return orig(self, x, *a)
                top = not inner
                if top:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                inner.append(0.0)
                try:
                    out = orig(self, x, *a)
                finally:
                    got = inner.pop()
                part = x.numel() * x.element_size()
                if not got:     # this call's own collective
                    got = part * (self.size - 1) / (
                        self.size if kind == "sum_chunk" else 1)
                if top:
                    torch.cuda.synchronize()
                    rec.append((kind, (time.perf_counter() - t0) * 1e3,
                                part, got))
                else:
                    inner[-1] += got
                return out
            return call
        return outer
    with contextlib.ExitStack() as st:
        for kind in ("sum", "cat", "sum_chunk"):
            st.enter_context(patched(tpm.TP, kind, wrap(kind)))
        yield rec


def model_sum_report(rec):
    """Per kind: calls, ms, and the GB a rank received and its rate (a
    gather's (m - 1) parts of its own size, a reduce-scatter's (m - 1) /
    m of it, a sum both of a chunk's)."""
    out = {}
    for kind in sorted({r[0] for r in rec}):
        rows = [r[1:] for r in rec if r[0] == kind]
        ms = sum(r[0] for r in rows)
        got = sum(r[2] for r in rows)
        out[kind] = {"calls": len(rows), "ms": ms,
                     "gb_received": got / 1e9,
                     "gb_per_s_received": got / ms / 1e6 if ms else None,
                     "largest_mb": max(r[1] for r in rows) / 1e6}
    return out


def dist_tp_qwen(torch, dist, ck, rank, world, out_dir, fsdp=False):
    """qwen3-4b at full width and depth on the model axis (data 1, model
    4) through launch.train.main, seq 512 x batch 8, 4 steps and a
    checkpoint: every loss and grad norm finite, the replicated leaves
    equal on every card, step ms, tokens a second, each card's peak after
    sharding and while the checkpoint's whole leaves are gathered, the
    save's seconds, the model group's sums; on card 0, step 0's loss
    against a forward of the same weights and batch whole on that card
    (17.6 GB of float32 weights) within DIST_TP_LOSS_TOL.  ``fsdp``: the
    same on the data axis (data 4, model 1) with ``--fsdp --remat
    full`` (the sharded init, its peak held to the shards and one whole
    leaf; the data group's gathers and reduce-scatters in place of the
    model group's sums, timed in the last step alone, which the median
    step leaves out)."""
    import gc
    import shutil
    import types
    from repro_torch.config import ParallelConfig, get_config
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data as D
    from repro_torch.training import train_step as ts
    cfg = get_config("qwen3-4b")
    dev = torch.device("cuda", rank)
    sums, held = [], {}
    ck_dir = pathlib.Path(out_dir) / "qwen_ckpt"

    def gathered(orig):
        def whole(*a, **k):
            torch.cuda.synchronize()
            held["train_peak_gib"] = \
                torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            held["save_gather_s"] = time.perf_counter() - t0
            held["save_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            held["save_held_gib"] = torch.cuda.memory_allocated() / 2**30
            return out
        return whole

    def written(orig):
        def save(path, step, tree, *a, **k):
            t0 = time.perf_counter()
            out = orig(path, step, tree, *a, **k)
            held["save_write_s"] = time.perf_counter() - t0
            held["save_gb"] = sum(
                v.numel() * v.element_size() for part in (
                    tree["params"], tree["opt"]["mu"], tree["opt"]["nu"])
                for v in part.values()) / 1e9
            return out
        return save

    def settle(orig):
        def shard(*a, **k):
            out = orig(*a, **k)
            torch.cuda.empty_cache()
            held["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
            held["after_shard_gib"] = torch.cuda.memory_allocated() / 2**30
            return out
        return shard
    from repro_torch.distributed.elastic import StepMonitor
    done = [0]

    def counted(orig):
        def observe(self, step, seconds):
            done[0] += 1
            return orig(self, step, seconds)
        return observe
    # under FSDP a step makes about a thousand collectives: time them in
    # the last step alone, so that the others' ms are the step's own
    when = (lambda: done[0] == DIST_TP_STEPS - 1) if fsdp else None
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    argv = ["--steps", str(DIST_TP_STEPS), "--seq", str(DIST_TP_SEQ),
            "--batch", str(DIST_TP_BATCH), "--log-every", "1",
            "--ckpt-dir", str(ck_dir)]
    argv += (["--fsdp", "--remat", "full"] if fsdp
             else ["--model-parallel", str(world)])
    with patched(M, "init_sharded", settle), \
            patched(tpm, "full_tree", gathered), \
            patched(ckpt, "save", written), \
            patched(StepMonitor, "observe", counted), \
            timed_model_sums(torch, sums, when):
        rec = lm_train(torch, cfg, argv)
    wall = time.perf_counter() - t0
    peak = held["train_peak_gib"]
    if rank == 0:
        if ckpt.latest_step(str(ck_dir)) != DIST_TP_STEPS:
            raise AssertionError(f"dist tp qwen3-4b: no checkpoint at "
                                 f"step {DIST_TP_STEPS} in {ck_dir}")
        ck.n += 1
        shutil.rmtree(ck_dir)
    lines, model = rec["lines"], rec["model"]
    # a card held its shards and one whole leaf at most (the mesh splits
    # over one axis, so a split leaf is whole at ``world`` shards)
    largest = max(p.numel() * world if tpm.fsdp_dim(p) is not None
                  or tpm.shard_dim(p) is not None else p.numel()
                  for p in model.parameters()) * 4
    held["largest_leaf_gib"] = largest / 2**30
    if held["init_peak_gib"] > (held["after_shard_gib"]
                                + largest / 2**30) * 1.01:
        raise AssertionError(f"dist tp qwen3-4b: the init's peak "
                             f"{held['init_peak_gib']:.3f} GiB beyond "
                             f"shards plus one whole leaf")
    ck.n += 1
    if [ln["step"] for ln in lines] != list(range(DIST_TP_STEPS)) or not all(
            np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"])
            for ln in lines) or int(rec["state"]["step"]) != DIST_TP_STEPS:
        raise AssertionError(f"dist tp qwen3-4b: {lines}")
    whole = [p for p in model.parameters() if tpm.shard_dim(p) is None
             and tpm.fsdp_dim(p) is None]
    prints = param_prints(torch, types.SimpleNamespace(
        parameters=lambda: iter(whole)))
    _same_on_ranks(torch, dist, prints, None,
                   "dist tp qwen3-4b replicated leaves")
    n_local = sum(p.numel() for p in model.parameters())
    ck.n += 2
    step_ms = [t * 1e3 for t in rec["step_s"]]
    med = statistics.median(step_ms[1:-1] if fsdp else step_ms[1:])
    timed = 1 if fsdp else len(lines)
    report = {"arch": cfg.name, "mesh": [world, 1] if fsdp else [1, world],
              "seq": DIST_TP_SEQ,
              "batch": DIST_TP_BATCH,
              "params": cfg.param_count(), "params_this_card": n_local,
              "replicated_leaves": len(whole), "lines": lines,
              "step_ms": step_ms, "median_step_ms": med,
              "tokens_per_s": DIST_TP_BATCH * DIST_TP_SEQ / med * 1e3,
              "peak_gib": peak,
              **held, "model_sums": model_sum_report(sums),
              "sums_per_step": len(sums) / timed, "wall_s": wall}
    if not fsdp and len(sums) % len(lines) == 0:   # the same calls a step
        per = len(sums) // len(lines)
        report["model_sums_by_step"] = [
            model_sum_report(sums[i * per:(i + 1) * per])
            for i in range(len(lines))]
    del rec, model, whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        pcfg = ParallelConfig(compute_dtype="float32")
        g = torch.Generator(device=dev).manual_seed(0)
        full = M.init_params(cfg, g, device=dev)
        b = D.SyntheticLM(cfg.vocab, DIST_TP_SEQ, DIST_TP_BATCH,
                          seed=0).batch(0)
        b = {k: torch.as_tensor(v).to(dev) for k, v in b.items()}
        t1 = time.perf_counter()
        with torch.no_grad():
            loss, _ = ts.lm_loss(cfg, pcfg, full, b)
        loss = float(loss)
        got = lines[0]["loss"]
        if abs(got - loss) > DIST_TP_LOSS_TOL:
            raise AssertionError(f"dist tp qwen3-4b step 0 loss {got} vs "
                                 f"one card's forward {loss}")
        ck.n += 1
        report["one_card_loss"] = {"loss": loss, "tp_loss": got,
                                   "abs_err": abs(got - loss),
                                   "forward_s": time.perf_counter() - t1}
        del full
        torch.cuda.empty_cache()
    dist.barrier()
    return report


def dist_tp_elastic(torch, dist, ck, rank, world, out_dir, fsdp=False):
    """check_elastic.py's flow at full width and depth: llama3.2-1b on
    (data 2, model 2), DIST_TRAIN_BATCH x DIST_TRAIN_SEQ, 3 steps (the
    data replicas' shards equal bit for bit after each), a checkpoint of
    whole leaves, remesh(2, model_parallel=2) and 3 more steps on (1, 2)
    (step == 6), the other ranks retired.  ``fsdp``: the leaves split
    over the data axis too and remat "full"."""
    from repro_torch.config import ParallelConfig, get_config
    from repro_torch.core.api import RankRetired
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.distributed.elastic import remesh
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    (dd, mm), (n2, m2), steps = DIST_TP_ELASTIC
    cfg = get_config("llama3.2-1b")
    pcfg = ParallelConfig(compute_dtype="float32",
                          remat="full" if fsdp else "none")
    dev = torch.device("cuda", rank)
    t0 = time.perf_counter()

    def fresh(mesh):
        g = torch.Generator(device=dev).manual_seed(0)
        model = M.init_sharded(cfg, pcfg, g, mesh, fsdp=fsdp, device=dev)
        torch.cuda.empty_cache()
        return model, opt.init_opt_state(model)
    mesh = lmesh.make_local_mesh(dd, mm, device=dev)
    model, state = fresh(mesh)
    torch.cuda.reset_peak_memory_stats()
    before = dist_train_steps(torch, dist, cfg, mesh, model, state,
                              range(steps), dev, pcfg)
    report = {"arch": cfg.name, "mesh": [dd, mm], "steps": before,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    t1 = time.perf_counter()
    tree = tpm.full_tree(model, state, mesh, keep=rank == 0)
    ck_dir = pathlib.Path(out_dir) / ("fsdp_ckpt" if fsdp else "tp_ckpt")
    if rank == 0:
        ckpt.save(str(ck_dir), steps, tree)
    del tree, model, state
    torch.cuda.empty_cache()
    dist.barrier()
    report["save_s"] = time.perf_counter() - t1
    try:
        mesh2 = remesh(n2, model_parallel=m2, device=dev)
    except RankRetired as e:
        report["remesh"] = {"outcome": "retired", "p": e.p}
    else:
        t1 = time.perf_counter()
        model, state = fresh(mesh2)
        ltrain.load_tree(model, state, ckpt.restore(
            str(ck_dir), steps, tpm.full_shapes(model, state)))
        restore_s = time.perf_counter() - t1
        after = dist_train_steps(torch, dist, cfg, mesh2, model, state,
                                 range(steps, 2 * steps), dev, pcfg)
        if int(state["step"]) != 2 * steps:
            raise AssertionError(f"dist tp remesh: step "
                                 f"{int(state['step'])}")
        ck.n += 1
        report["remesh"] = {"outcome": "recovered", "mesh": [n2 // m2, m2],
                            "restore_s": restore_s, "steps": after,
                            "step": int(state["step"])}
        del model, state
    for ln in report["steps"] + report["remesh"].get("steps", []):
        if not (np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"])):
            raise AssertionError(f"dist tp remesh: not finite {ln}")
    ck.n += 1
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    return report


def dist_tp_moe(torch, dist, ck, rank, world, reps):
    """One DeepSeek-V2-Lite MoE layer at full width, LM_MOE_TOKENS
    tokens, expert-parallel over the four cards (E / 4 = 16 experts a
    card; ``moe.moe_tp`` on a (1, 4) mesh): forward and backward under
    dispatch="spmm" against "einsum", every leaf (this card's expert
    shards, the replicated router and shared experts, the input) within
    1e-3 of its largest magnitude; this card's launches of one counted
    pass (4 bulk SpMM and 1 SDDMM), and its three backward launches
    against their plain versions with ms, bound, plain and library ms.
    Returns (report, launches)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cut, _ = deepseek_cut()
    pcfg = ParallelConfig(compute_dtype="float32")
    mesh = lmesh.make_local_mesh(1, world, device=torch.device("cuda", rank))
    tp = tpm.of_mesh(mesh, pcfg)
    g = torch.Generator(device="cuda").manual_seed(7)
    layer = MOE.MoE(L.Init(g, torch.float32, "cuda"), cut)
    B, S = LM_MOE_TOKENS
    x = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    proj = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    for k in ("w1", "w3", "w2"):      # this card's experts
        part = torch.nn.Parameter(tpm.local_part(
            getattr(layer, k).data, 0, rank, world).clone())
        part.tp_dim = 0
        layer._parameters[k] = part
    torch.cuda.empty_cache()
    leaves = dict(layer.named_parameters())

    def step(dispatch):
        for p in leaves.values():
            p.grad = None
        xx = x.clone().requires_grad_(True)
        (part, rep), aux = MOE.moe_tp(cut, pcfg, layer, tp.enter(xx), tp,
                                      dispatch=dispatch)
        out = tp.exit(part, rep)
        ((out * proj).sum() + TRAIN_LM_AUX * aux["lb_loss"]).backward()
        return {"x": xx.grad, **{k: p.grad for k, p in leaves.items()}}

    want = {k: v.clone() for k, v in step("einsum").items()}
    ops.reset_launch_counts()
    got = step("spmm")
    torch.cuda.synchronize()
    launches, forms = ops.launch_counts(), ops.form_counts()
    if launches["spmm"] != 4 or forms["spmm"].get("bulk", 0) != 4 or \
            launches["sddmm"] != 1 or launches["fusedmm"] != 0:
        raise AssertionError(f"dist tp moe: expected 4 bulk SpMM and 1 "
                             f"SDDMM launches, got {launches} {forms}")
    errs = _leaf_check(ck, got, want, TRAIN_LM_MOE_TOL,
                       f"dist tp moe card {rank} spmm vs einsum")
    sums = []
    with timed_model_sums(torch, sums):
        step("spmm")
    report = {"experts_this_card": cut.moe_experts // world,
              "tokens": B * S, "launches": launches, "forms": forms,
              "leaf_err": errs,
              "spmm_ms": time_ms(torch, lambda: step("spmm"), reps),
              "einsum_ms": time_ms(torch, lambda: step("einsum"), reps),
              "model_sums": model_sum_report(sums),
              "kernels": train_lm_moe_kernels(torch, ck, cut, layer, x,
                                              proj, reps, rank, world)}
    for p in leaves.values():
        p.grad = None
    del layer, leaves, got, want
    torch.cuda.empty_cache()
    return report, launches


def dist_tp_sum_forms(torch, dist, ck, rank, world, reps):
    """The model group's sum of qwen3-4b's operands (DIST_TP_SUM_SHAPES)
    in two forms, in turns, the card synchronised around each: "whole"
    (``TP.sum``: the parts all-gathered, every rank adding all m) and
    "chunked" (each rank adds one chunk of the parts, exchanged all to
    all by ``TP.sum_chunk``, and the sums are all-gathered: 2 (m - 1) / m
    of the bytes received in place of m - 1, two collectives in place of
    one); equal bit for bit; the median ms of each and the GB/s a rank
    received."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.launch import mesh as lmesh
    mesh = lmesh.make_local_mesh(1, world, device=torch.device("cuda", rank))
    tp = tpm.of_mesh(mesh, ParallelConfig())

    def chunked(x):
        return tp.cat(tp.sum_chunk(x, 0), 0)
    g = torch.Generator(device="cuda").manual_seed(11 + rank)
    out = {}
    for name, shape in DIST_TP_SUM_SHAPES.items():
        x = torch.randn(shape, generator=g, device="cuda")
        if not torch.equal(tp.sum(x), chunked(x)):
            raise AssertionError(f"dist tp sums: {name}'s two forms differ")
        ck.n += 1
        forms = {"whole": tp.sum, "chunked": chunked}
        ms = {form: [] for form in forms}
        for i in range(reps + 2):       # the first two rounds warm up
            for form, fn in forms.items():
                _, t = timed_call(torch, lambda: fn(x))
                if i >= 2:
                    ms[form].append(t)
        n = x.numel() * x.element_size()
        got = {"whole": (world - 1) * n,
               "chunked": 2 * (world - 1) / world * n}
        out[name] = {"mb": n / 1e6, **{form: {
            "ms": statistics.median(t),
            "gb_per_s_received": got[form] / statistics.median(t) / 1e6}
            for form, t in ms.items()}}
    return out


#: (F3)'s launches a card: a counted forward and backward, and the same
#: under remat (the recompute launches the dispatch and combine again)
DIST_FSDP_MOE_LAUNCHES = {
    "none": {"spmm": {"bulk": 4}, "sddmm": {"load": 1}},
    "full": {"spmm": {"bulk": 6}, "sddmm": {"load": 1}}}


def dist_fsdp_moe(torch, dist, ck, rank, world, reps):
    """(F3) one DeepSeek-V2-Lite MoE layer at full width under FSDP over
    the four cards (data 4, model 1): every leaf the config's placement
    splits (``sharding.fsdp_dims`` of the stacked MoE layer: the experts,
    the router, the shared experts) holds this card's shard and is
    gathered before use; each card takes one row of LM_MOE_TOKENS,
    routed over the data group.  Forward and backward under
    dispatch="spmm" against "einsum", every gradient shard and the
    input's gradient within TRAIN_LM_MOE_TOL of its largest magnitude;
    the same under remat (``torch.utils.checkpoint``) equal to the pass
    without it bit for bit; each card's launches and forms of a counted
    pass held to DIST_FSDP_MOE_LAUNCHES; the backward's launches at the
    layer's shapes against bound, plain and library.  Returns (report,
    launches)."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import sharding
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.training import train_step as ts
    cut, full = deepseek_cut()
    pcfg = ParallelConfig(compute_dtype="float32")
    mesh = lmesh.make_local_mesh(world, 1, device=torch.device("cuda", rank))
    fs = fsdp.of_mesh(mesh, pcfg)
    dims = sharding.fsdp_dims(full, pcfg, M.empty_model(full), mesh)
    prefix = "segments.1.0.blk0.moe."
    g = torch.Generator(device="cuda").manual_seed(7)
    layer = MOE.MoE(L.Init(g, torch.float32, "cuda"), cut)
    B, S = LM_MOE_TOKENS
    x = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    proj = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    split = {}
    for n, p in list(layer.named_parameters()):
        d = dims[prefix + n]
        if d is None:
            continue
        owner, leaf = tpm._owner(layer, n)
        part = torch.nn.Parameter(tpm.local_part(p.data, d, rank,
                                                 world).clone())
        part.fsdp_dim = d
        owner._parameters[leaf] = part
        split[n] = d
    if not {"w1", "w3", "w2"} <= set(split):
        raise AssertionError(f"dist fsdp moe: the experts are not split: "
                             f"{split}")
    torch.cuda.empty_cache()
    leaves = dict(layer.named_parameters())
    xr, pr = x[rank:rank + 1].contiguous(), proj[rank:rank + 1].contiguous()

    def step(dispatch, remat="none"):
        for p in leaves.values():
            p.grad = None
        xx = xr.clone().requires_grad_(True)

        def run(xx):
            out, aux = MOE.moe(cut, pcfg, fsdp.gathered(layer, fs), xx,
                               dispatch=dispatch, group=mesh.data_group)
            return out, aux["lb_loss"]
        out, aux = (run(xx) if remat == "none"
                    else checkpoint(run, xx, use_reentrant=False))
        ((out * pr).sum() + TRAIN_LM_AUX * aux).backward()
        ts.ordered_sum([p.grad for p in leaves.values()
                        if tpm.fsdp_dim(p) is None], mesh.data_group)
        return {"x": xx.grad, **{k: p.grad for k, p in leaves.items()}}

    want = {k: v.clone() for k, v in step("einsum").items()}
    launches, forms, got = {}, {}, {}
    for remat in ("none", "full"):
        ops.reset_launch_counts()
        got[remat] = {k: v.clone() for k, v in step("spmm", remat).items()}
        torch.cuda.synchronize()
        launches[remat], forms[remat] = (ops.launch_counts(),
                                         ops.form_counts())
        pred = DIST_FSDP_MOE_LAUNCHES[remat]
        seen = {k: dict(forms[remat][k]) for k in pred}
        if seen != pred or launches[remat]["fusedmm"] != 0:
            raise AssertionError(f"dist fsdp moe ({remat}): expected "
                                 f"{pred}, got {launches[remat]} "
                                 f"{forms[remat]}")
        ck.n += 1
    errs = _leaf_check(ck, got["none"], want, TRAIN_LM_MOE_TOL,
                       f"dist fsdp moe card {rank} spmm vs einsum")
    for k, v in got["none"].items():
        if not torch.equal(v, got["full"][k]):
            raise AssertionError(f"dist fsdp moe: {k} differs under remat")
    ck.n += 1
    gathers = []
    with timed_model_sums(torch, gathers):
        step("spmm")
    with torch.no_grad():
        view = fsdp.gathered(layer, fs)
        kernels = train_lm_moe_kernels(torch, ck, cut, view, xr, pr, reps,
                                       group=mesh.data_group)
        del view
    report = {"split": split, "tokens_this_card": S,
              "tokens": B * S, "launches": launches["none"],
              "forms": forms["none"], "remat_launches": launches["full"],
              "remat_forms": forms["full"], "leaf_err": errs,
              "spmm_ms": time_ms(torch, lambda: step("spmm"), reps),
              "einsum_ms": time_ms(torch, lambda: step("einsum"), reps),
              "spmm_remat_ms": time_ms(torch, lambda: step("spmm", "full"),
                                       reps),
              "data_sums": model_sum_report(gathers),
              "kernels": kernels}
    for p in leaves.values():
        p.grad = None
    del layer, leaves, got, want
    torch.cuda.empty_cache()
    return report, launches["none"]


def dist_fsdp_no_remat(torch, ck, qwen):
    """(F1') qwen3-4b at (4, 1) through launch.train.main --fsdp without
    remat, 2 steps, no checkpoint: the blocks' gathered leaves that their
    backward reads stay alive until it runs, so each card's peak holds
    every block's whole leaves; its step ms beside (F1)'s; both steps'
    losses equal (F1)'s bit for bit."""
    import gc
    from repro_torch.config import get_config
    cfg = get_config("qwen3-4b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = lm_train(torch, cfg, ["--steps", "2", "--seq", str(DIST_TP_SEQ),
                                "--batch", str(DIST_TP_BATCH),
                                "--log-every", "1", "--fsdp"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [ln["loss"] for ln in rec["lines"]]
    if losses != [ln["loss"] for ln in qwen["lines"][:2]]:
        raise AssertionError(f"dist fsdp qwen3-4b without remat: losses "
                             f"{losses}, with remat {qwen['lines'][:2]}")
    ck.n += 1
    out = {"losses": losses, "peak_gib": peak,
           "step_ms": [t * 1e3 for t in rec["step_s"]]}
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_fsdp(torch, dist, ck, rank, world, out_dir):
    """FSDP over the data axis on DIST_TP_WORLD cards: (F1) qwen3-4b at
    (4, 1) through launch.train.main --fsdp --remat full, then 2 steps
    without remat; (F2)
    llama3.2-1b's remesh flow at (2, 2) with FSDP and remat against the
    same flow without either; (F3) the DeepSeek-V2-Lite MoE layer's
    leaves split, its SpMM and SDDMM launched."""
    import gc
    t0 = time.perf_counter()
    out = {"qwen": dist_tp_qwen(torch, dist, ck, rank, world, out_dir,
                                fsdp=True)}
    out["seconds_qwen"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["qwen_no_remat"] = dist_fsdp_no_remat(torch, ck, out["qwen"])
    out["seconds_qwen_no_remat"] = time.perf_counter() - t0
    flows = {k: dist_tp_elastic(torch, dist, ck, rank, world, out_dir,
                                fsdp=k == "fsdp")
             for k in ("plain", "fsdp")}
    a, b = flows["plain"], flows["fsdp"]
    la = [ln["loss"] for ln in a["steps"] + a["remesh"].get("steps", [])]
    lb = [ln["loss"] for ln in b["steps"] + b["remesh"].get("steps", [])]
    if len(la) != len(lb) or la[0] != lb[0] or max(
            abs(u - v) for u, v in zip(la, lb)) > DIST_FSDP_FLOW_TOL:
        raise AssertionError(f"dist fsdp remesh: losses {lb} against "
                             f"{la} without FSDP")
    ck.n += 1
    out["elastic"] = dict(b, plain=a, loss_err=max(
        abs(u - v) for u, v in zip(la, lb)))
    out["seconds_elastic"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["moe"], out["launches"] = dist_fsdp_moe(torch, dist, ck, rank,
                                                world, 3)
    out["seconds"] = time.perf_counter() - t0
    return out


def dist_fsdp_report(ranks, world):
    """Rank 0's FSDP record with each card's peaks, step ms, the data
    group's gathers and reduce-scatters, and the MoE layer's launches
    and kernel times; the remesh outcomes checked."""
    rep = dict(ranks[0]["fsdp"])
    outs = [rr["fsdp"]["elastic"]["remesh"]["outcome"] for rr in ranks]
    n2 = DIST_TP_ELASTIC[1][0]
    if outs != ["recovered"] * n2 + ["retired"] * (world - n2):
        raise AssertionError(f"dist fsdp remesh: outcomes {outs}")
    rep["cards"] = [{
        "rank": rr["rank"],
        **{f"qwen_{k}": rr["fsdp"]["qwen"][k] for k in (
            "init_peak_gib", "after_shard_gib", "peak_gib", "save_peak_gib",
            "save_gather_s", "step_ms", "model_sums")},
        "qwen_no_remat_peak_gib": rr["fsdp"]["qwen_no_remat"]["peak_gib"],
        "qwen_no_remat_step_ms": rr["fsdp"]["qwen_no_remat"]["step_ms"],
        "elastic_peak_gib": rr["fsdp"]["elastic"]["peak_gib"],
        "elastic_loss_err": rr["fsdp"]["elastic"]["loss_err"],
        "moe_launches": rr["fsdp"]["moe"]["launches"],
        "moe_remat_launches": rr["fsdp"]["moe"]["remat_launches"],
        "moe_leaf_err": max(rr["fsdp"]["moe"]["leaf_err"].values()),
        "moe_kernels": rr["fsdp"]["moe"]["kernels"]}
        for rr in ranks]
    return rep


def dist_tp(torch, dist, ck, rank, world, out_dir):
    """The tensor-parallel cells on DIST_TP_WORLD cards: the model group's
    sum in its two forms, qwen3-4b through launch.train.main on the model
    axis, llama3.2-1b's remesh flow, the expert-parallel MoE layer."""
    t0 = time.perf_counter()
    out = {"sum_forms": dist_tp_sum_forms(torch, dist, ck, rank, world,
                                          DIST_TP_SUM_REPS)}
    out["qwen"] = dist_tp_qwen(torch, dist, ck, rank, world, out_dir)
    out["seconds_qwen"] = time.perf_counter() - t0
    out["elastic"] = dist_tp_elastic(torch, dist, ck, rank, world, out_dir)
    out["seconds_elastic"] = time.perf_counter() - t0
    out["moe"], out["launches"] = dist_tp_moe(torch, dist, ck, rank, world,
                                              3)
    out["seconds"] = time.perf_counter() - t0
    return out


def dist_tp_report(ranks, world):
    """Rank 0's tensor-parallel record with each card's peak, step ms,
    sums and kernel times; the remesh outcomes checked."""
    rep = dict(ranks[0]["tp"])
    outs = [rr["tp"]["elastic"]["remesh"]["outcome"] for rr in ranks]
    n2 = DIST_TP_ELASTIC[1][0]
    if outs != ["recovered"] * n2 + ["retired"] * (world - n2):
        raise AssertionError(f"dist tp remesh: outcomes {outs}")
    rep["cards"] = [{
        "rank": rr["rank"],
        "qwen_peak_gib": rr["tp"]["qwen"]["peak_gib"],
        "qwen_save_peak_gib": rr["tp"]["qwen"]["save_peak_gib"],
        "qwen_save_gather_s": rr["tp"]["qwen"]["save_gather_s"],
        "qwen_step_ms": rr["tp"]["qwen"]["step_ms"],
        "qwen_model_sums": rr["tp"]["qwen"]["model_sums"],
        "elastic_peak_gib": rr["tp"]["elastic"]["peak_gib"],
        "elastic_outcome": o,
        "moe_launches": rr["tp"]["moe"]["launches"],
        "moe_leaf_err": max(rr["tp"]["moe"]["leaf_err"].values()),
        "moe_kernels": rr["tp"]["moe"]["kernels"]}
        for rr, o in zip(ranks, outs)]
    return rep


#: (S1)/(S2): launch.serve.main's arguments beside --model-parallel, the
#: slots the cache is extended to (the reference's decode_32k length) and
#: the decode steps timed there
DIST_SERVE_TP_ARGS = ["--batches", "2", "--batch", "4", "--prompt-len",
                      "512", "--gen", "32"]
DIST_SERVE_TP_SLOTS = 32768
DIST_SERVE_TP_LONG_STEPS = 16
#: (S3): jamba's MoE layer at a decode step's tokens and at prefill's
DIST_SERVE_TP_MOE = {"decode": (4, 1), "prefill": (4, 512)}


def no_drop(cfg):
    """``cfg`` with a capacity factor at which no assignment is dropped
    (C >= T a expert): a decode step of 4 tokens has capacity 1 at the
    configs' 1.25, so a cached step and a teacher-forced forward of the
    same tokens would route differently by design; widths and depth
    stay."""
    import dataclasses
    return dataclasses.replace(
        cfg, capacity_factor=(cfg.moe_experts + 0.5) / cfg.moe_top_k)


def whole_cache_bytes(torch, cfg, B, S):
    """Bytes of the whole cache of ``B`` rows and ``S`` positions in
    float32 (the compute dtype the serve driver's caches hold), its fill
    counters left out."""
    from repro_torch.models import model as M
    return cache_bytes(M.init_cache(cfg, B, S, torch.float32,
                                    device="meta"))


def serve_tp_cell(torch, dist, ck, rank, world, cfg, tag):
    """(S1)/(S2): ``cfg`` through launch.serve.main --model-parallel
    ``world`` (the sharded init, seq_shard_decode), DIST_SERVE_TP_ARGS:
    every decode step's and prefill's logits against a teacher-forced
    forward of the same tokens on the same cards (the uncached
    ``_forward_tp``) within LM_TF_TOL; each card's cache bytes a quarter
    of the whole cache's after prefill and while decoding; then the first
    batch's prompt prefilled again and its cache extended to
    DIST_SERVE_TP_SLOTS slots (each card a block of them), its first
    step's logits against the served first step's within LM_TF_TOL, and
    DIST_SERVE_TP_LONG_STEPS decode steps timed there, and one more
    step's device split.  Returns (report, the model, the mesh)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import sharding
    from repro_torch.serving import decode
    B, S, G = (int(DIST_SERVE_TP_ARGS[i]) for i in (3, 5, 7))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = lm_serve(torch, cfg, DIST_SERVE_TP_ARGS + [
        "--model-parallel", str(world)], caches=True)
    serve_s = time.perf_counter() - t0
    model, mesh = rec["models"][0], rec["meshes"][0]
    pcfg = ParallelConfig(compute_dtype="float32", seq_shard_decode=True)
    report = {"arch": cfg.name, "params": cfg.param_count(),
              "params_this_card": sum(p.numel() for p in model.parameters()),
              "mesh": [1, world], "batch": B, "prompt": S, "gen": G,
              "capacity_factor": cfg.capacity_factor,
              "batches": lm_report(rec), "serve_s": serve_s,
              "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    fills = {"prefill": S, "decode": S + G}
    for key, fill in fills.items():
        whole = whole_cache_bytes(torch, cfg, B, fill)
        got = set(rec[key + "_cache"])
        if got != {whole // world} or whole % world:
            raise AssertionError(f"dist serve tp {tag}: {key} cache bytes "
                                 f"{got} a card, whole {whole}")
        ck.n += 1
        report[f"{key}_cache_gib"] = {"card": whole / world / 2**30,
                                      "whole": whole / 2**30}
    sharding.set_mesh(mesh)
    try:
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        report["teacher_forcing_err"] = lm_teacher_forcing(
            torch, ck, cfg, pcfg, model, rec)
        report["teacher_forcing_s"] = time.perf_counter() - t1
        report["teacher_peak_gib"] = \
            torch.cuda.max_memory_allocated() / 2**30
        prompt = rec["prefill"][0][0]
        first = rec["decode"][0]
        torch.cuda.reset_peak_memory_stats()
        logits, cache = decode.prefill(cfg, pcfg, model, {"tokens": prompt})
        cache = decode.extend_cache(cache, DIST_SERVE_TP_SLOTS - S, pcfg)
        per = DIST_SERVE_TP_SLOTS // world
        leaf = "c_kv" if cfg.mla_kv_lora else "k"
        blocks = {x[leaf].shape[1] for seg in cache["segments"]
                  for rep in seg for x in rep.values() if leaf in x}
        if blocks != {per}:
            raise AssertionError(f"dist serve tp {tag}: {leaf} blocks "
                                 f"{blocks}, want {per} a card")
        ck.n += 1
        tok = first[0]
        lat, outs = [], []
        for _ in range(DIST_SERVE_TP_LONG_STEPS):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            logits, cache = decode.decode_step(cfg, pcfg, model,
                                               {"tokens": tok}, cache)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t2) * 1e3)
            outs.append(logits)
            tok = logits[:, -1].argmax(-1)[:, None]
        long_err = ck.close(outs[0], first[1], LM_TF_TOL,
                            f"dist serve tp {tag} first step at "
                            f"{DIST_SERVE_TP_SLOTS} slots vs {S + G}")
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError(f"dist serve tp {tag}: non-finite logits "
                                 f"at {DIST_SERVE_TP_SLOTS} slots")
        ck.n += 1
        # one step's device split (torch.profiler): every rank profiles
        # the same calls, so the collectives line up
        split = device_breakdown(torch, lambda: decode.decode_step(
            cfg, pcfg, model, {"tokens": tok}, cache))
        report["long"] = {
            "device_split": split,
            "slots": DIST_SERVE_TP_SLOTS, "slots_this_card": per,
            "cache_gib_card": cache_bytes(cache) / 2**30,
            "steps": DIST_SERVE_TP_LONG_STEPS, "step_ms": lat,
            "decode_p50_ms": float(np.median(lat[1:])),
            "decode_p99_ms": float(np.quantile(lat[1:], 0.99)),
            "first_step_err": long_err,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del cache, logits, outs
    finally:
        sharding.set_mesh(None)
    report["decode_p50_ms"] = [ln["decode_p50_ms"] for ln in rec["lines"]]
    report["decode_p99_ms"] = [ln["decode_p99_ms"] for ln in rec["lines"]]
    report["prefill_s"] = [ln["prefill_s"] for ln in rec["lines"]]
    report["init_peak_gib"] = rec["lines"][0].get("init_peak_gib")
    report["peak_gib_cards"] = rec["lines"][-1].get("peak_gib")
    del rec
    torch.cuda.empty_cache()
    return report, model, mesh


def serve_tp_moe(torch, ck, cfg, layer, mesh, rank, world, reps):
    """(S3): jamba's MoE layer expert-parallel over the model group (this
    card's E / world experts; ``moe.moe_tp``) at DIST_SERVE_TP_MOE's
    tokens: dispatch="spmm" (the Hopper SpMM) against "einsum" within
    LM_MOE_TOL, this card's share and the group's sum; the launches and
    forms of one counted call (2 SpMM), both calls' ms, and this share's
    dispatch and combine packs' kernel against its plain version with
    its bound, plain and torch.sparse.mm ms.  Returns (report, the
    prefill shape's counted launches)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed import tensor_parallel as tpm
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    pcfg = ParallelConfig(compute_dtype="float32")
    tp = tpm.of_mesh(mesh, pcfg)
    out, counted = {}, None
    for shape, (B, S) in DIST_SERVE_TP_MOE.items():
        g = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((B, S, cfg.d_model), generator=g, device="cuda")
        with torch.inference_mode():

            def call(dispatch, x=x):
                return MOE.moe_tp(cfg, pcfg, layer, tp.enter(x), tp,
                                  dispatch=dispatch)[0]
            want = call("einsum")
            ops.reset_launch_counts()
            got = call("spmm")
            torch.cuda.synchronize()
            launches, forms = ops.launch_counts(), ops.form_counts()
            if launches["spmm"] != 2 or launches["sddmm"] != 0 or \
                    launches["fusedmm"] != 0:
                raise AssertionError(f"dist serve tp moe {shape}: expected "
                                     f"2 SpMM launches, got {launches}")
            err = ck.close(got[0], want[0], LM_MOE_TOL,
                           f"dist serve tp moe {shape} card {rank} share "
                           f"spmm vs einsum")
            err_sum = ck.close(tp.exit(*got), tp.exit(*want), LM_MOE_TOL,
                               f"dist serve tp moe {shape} layer spmm vs "
                               f"einsum")
            C = MOE.route(cfg, layer, x.reshape(-1, cfg.d_model))[5]
            out[shape] = {
                "tokens": B * S, "capacity": C,
                "experts_this_card": cfg.moe_experts // world,
                "launches": launches, "forms": forms, "share_err": err,
                "layer_err": err_sum,
                "spmm_ms": time_ms(torch, lambda: call("spmm"), reps),
                "einsum_ms": time_ms(torch, lambda: call("einsum"), reps),
                "packs": lm_moe_packs(torch, ck, cfg, layer, x, reps, rank,
                                      world)}
        if shape == "prefill":
            counted = launches
        del x, want, got
    torch.cuda.empty_cache()
    return out, counted


def dist_serve_tp(torch, dist, ck, rank, world, out_dir):
    """Serving under the mesh's model axis on DIST_TP_WORLD cards: (S1)
    jamba-v0.1-52b at full size (51.5e9 parameters, 205.8 GB in float32:
    no card holds it) through launch.serve.main --model-parallel 4, (S3)
    its MoE layer's SpMM dispatch expert-parallel, (S2) DeepSeek-V2-Lite
    at full width with its depth cut to 4 layers, the same as (S1)."""
    import gc
    from repro_torch.config import get_config
    t0 = time.perf_counter()
    cfg = no_drop(get_config("jamba-v0.1-52b"))
    out = {}
    out["jamba"], model, mesh = serve_tp_cell(torch, dist, ck, rank, world,
                                              cfg, "jamba")
    out["seconds_jamba"] = time.perf_counter() - t0
    layer = model.segments[0][0].blk1.moe
    out["moe"], out["launches"] = serve_tp_moe(
        torch, ck, get_config("jamba-v0.1-52b"), layer, mesh, rank, world,
        3)
    out["seconds_moe"] = time.perf_counter() - t0
    del model, layer, mesh
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    cut, full = deepseek_cut()
    out["deepseek"], model, _ = serve_tp_cell(torch, dist, ck, rank, world,
                                              no_drop(cut), "deepseek")
    out["deepseek"]["cut"] = (
        f"layers {full.n_layers} -> {cut.n_layers} (the dense layer 0 and "
        f"3 MoE layers), params {full.param_count()} -> "
        f"{cut.param_count()}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def dist_serve_tp_report(ranks, world):
    """Rank 0's serving record with each card's peaks, decode times and
    MoE launches and kernel times."""
    rep = dict(ranks[0]["serve_tp"])
    rep["cards"] = [{
        "rank": rr["rank"],
        **{f"{cell}_{k}": rr["serve_tp"][cell][k]
           for cell in ("jamba", "deepseek")
           for k in ("params_this_card", "serve_peak_gib", "teacher_peak_gib",
                     "decode_p50_ms", "teacher_forcing_err")},
        **{f"{cell}_long": {k: rr["serve_tp"][cell]["long"][k] for k in (
            "decode_p50_ms", "decode_p99_ms", "peak_gib", "cache_gib_card")}
           for cell in ("jamba", "deepseek")},
        "moe_launches": rr["serve_tp"]["launches"],
        "moe": {shape: {k: c[k] for k in ("share_err", "layer_err",
                                           "spmm_ms", "einsum_ms", "packs")}
                for shape, c in rr["serve_tp"]["moe"].items()}}
        for rr in ranks]
    return rep


def serve_tp_kernel_row(ranks):
    """The ``kernels`` line's SpMM row of the serving phase: the counted
    launches of (S3)'s prefill-shape call on card 0 and that share's
    dispatch pack's kernel against its bound, plain and library times."""
    rr = ranks[0]["serve_tp"]
    pack = rr["moe"]["prefill"]["packs"]["dispatch"]
    return [{"name": "spmm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/spmm.cu",
             "replaces": "src/repro/kernels/spmm.py:52",
             "launches": rr["launches"]["spmm"],
             "max_abs_err": pack["max_abs_err"], "ms": pack["ms"],
             "plain_ms": pack["plain_ms"], "bound_ms": pack["bound_ms"],
             "bound_by": pack["bound_by"], "library_ms": pack["library_ms"],
             "dist_serve_tp_launches": [r["serve_tp"]["launches"]["spmm"]
                                        for r in ranks],
             "packs": {shape: c["packs"]
                       for shape, c in rr["moe"].items()}}]


def dist_train_report(ranks, world):
    """Rank 0's train record with each rank's outcome and step ms; the
    remesh outcomes checked."""
    rep = dict(ranks[0]["train"])
    if world > 1:
        outs = [rr["train"]["remesh"]["outcome"] for rr in ranks]
        want = ["recovered"] * DIST_TRAIN_REMESH + ["retired"] * (
            world - DIST_TRAIN_REMESH)
        if outs != want:
            raise AssertionError(f"dist train remesh: outcomes {outs}")
        rep["ranks"] = [{"rank": rr["rank"], "outcome": o,
                         "step_ms": [s["ms"] for s in rr["train"]["steps"]],
                         "grad_sum": rr["train"]["grad_sum"]}
                        for rr, o in zip(ranks, outs)]
    return rep


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist(torch, scale: int, reps: int, comm_scale: int,
               apps_scale: int, only: str | None = None):
    """One process per visible card over NCCL (``dist_rank``); fails if
    a rank fails or any outlives DIST_TIMEOUT_S (all are stopped).
    ``only``: "serving", "train", "tp", "tp_sums", "fsdp" or "serve_tp"
    runs those cells alone (a cheaper rehearsal; "serve_tp" runs only so).
    Returns (a rank's d15 launches, each rank's serving launches, each
    rank's tensor-parallel and FSDP MoE launches, the serving-on-the-
    model-axis kernel rows), None where the cells did not run."""
    import multiprocessing
    import signal
    import tempfile
    world = torch.cuda.device_count()
    # the link matrix, where nvidia-smi can read it on this machine
    topo = []
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "-s"]):
        got = subprocess.run(cmd, capture_output=True, text=True)
        topo += (got.stdout + got.stderr).splitlines() + [
            f"({' '.join(cmd)} exited {got.returncode})"]
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.splitlines()
    for ln in topo:
        log(f"[topo] {ln}")
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        init = f"tcp://localhost:{_free_port()}"
        procs = [ctx.Process(target=dist_rank, args=(rk, world, init, scale,
                                                     reps, comm_scale,
                                                     out_dir, apps_scale,
                                                     only))
                 for rk in range(world)]
        # a SIGTERM (a time limit around the script) unwinds through the
        # finally below, which stops every rank
        old = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_TIMEOUT_S
        try:
            while any(p.is_alive() for p in procs):
                if time.monotonic() > deadline:
                    raise AssertionError(f"dist: a rank ran past "
                                         f"{DIST_TIMEOUT_S} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
            signal.signal(signal.SIGTERM, old)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"dist: ranks exited {codes}")
        ranks = [json.loads((pathlib.Path(out_dir) / f"rank{rk}.json")
                            .read_text()) for rk in range(world)]
    peer = [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(world)] for i in range(world)]
    report = {"phase": "dist", "world": world, "cards": cards,
              "topology": topo, "peer_access": peer, "rank0": ranks[0],
              "ranks": [{"rank": rr["rank"], "checks": rr["checks"], "ms": {
                  a: {el: c["ms"] for el, c in pr["cells"].items()}
                  for a, pr in rr["problems"].items()},
                  "launches": {a: pr["launches"]
                               for a, pr in rr["problems"].items()},
                  "rmat_ms": {a: {w: cw["ms"] for w, cw in cell.items()}
                              for a, cell in rr.get("rmat", {})
                              .get("cells", {}).items()},
                  "faults": rr.get("faults")}
                  for rr in ranks]}
    if only in (None, "serving"):
        serve = ranks[0]["serving"]
        report["serving"] = dict(serve, ranks=[{
            "rank": rr["rank"], "seconds": rr["serving"]["seconds"],
            "launches": rr["serving"]["launches"],
            "deploy_s": rr["serving"].get("als", {}).get("deploy"),
            "gat_deploy_s": rr["serving"].get("gat", {}).get("deploy"),
            "losses": rr["serving"].get("als", {}).get("losses")}
            for rr in ranks])
    if only in (None, "train"):
        report["train"] = dist_train_report(ranks, world)
    tp_launches = fsdp_launches = None
    if only in (None, "tp") and world == DIST_TP_WORLD:
        report["tp"] = dist_tp_report(ranks, world)
        tp_launches = [rr["tp"]["launches"] for rr in ranks]
    if only in (None, "fsdp") and world == DIST_TP_WORLD:
        report["fsdp"] = dist_fsdp_report(ranks, world)
        fsdp_launches = [rr["fsdp"]["launches"] for rr in ranks]
    if only == "tp_sums":
        report["tp_sums"] = [rr["tp_sums"] for rr in ranks]
    serve_tp_rows = None
    if only == "serve_tp":
        report["serve_tp"] = dist_serve_tp_report(ranks, world)
        serve_tp_rows = serve_tp_kernel_row(ranks)
    if world > 1 and only is None:
        # the survivors recovered onto the degraded group, every other
        # rank (the lost one among them) retired
        outs = [rr["faults"]["outcome"] for rr in ranks]
        p_after = ranks[0]["faults"]["p_after"]
        if outs != ["recovered"] * p_after + ["retired"] * (world - p_after) \
                or outs[DIST_FAULT_LOST] != "retired":
            raise AssertionError(f"dist faults: outcomes {outs}")
    if world > 1 and only in (None, "serving"):
        # serving: the first loss retires the ranks past the degraded p,
        # the second every survivor but the front end; the rest followed
        first, second = ([rr["serving"]["als"]["losses"][i]["outcome"]
                          for rr in ranks] for i in (0, 1))
        p1 = serve["als"]["losses"][0]["p_after"]
        if first != ["recovered"] * p1 + ["retired"] * (world - p1) or \
                first[DIST_SERVE_LOST[0]] != "retired" or \
                second != ["recovered"] + ["retired"] * (p1 - 1) \
                + ["away"] * (world - p1):
            raise AssertionError(f"dist serving: outcomes {first}, "
                                 f"{second}")
    emit(report)
    return (None if only else ranks[0]["problems"]["d15"]["launches"],
            [rr["serving"]["launches"] for rr in ranks]
            if only in (None, "serving") else None, tp_launches,
            fsdp_launches, serve_tp_rows)


# ---------------------------------------------------------------------------
# serving: repro_torch.serving on the card
# ---------------------------------------------------------------------------

#: stacked ranks of cell A's deployment, and the ranks its two faults lose
SERVE_P, SERVE_LOST = 8, (FAULT_LOST, 3)
#: cell A's score traffic: hot query patterns, (user, item) pairs each,
#: open-loop burst period (simulated s), measured bursts, clients a burst
SERVE_CATALOG, SERVE_QUERY = 8, 1024
SERVE_PERIOD, SERVE_BURSTS = 0.01, 4
SERVE_CONCURRENCY = (1, 8, 32)
#: lookup widths, all in one tick (they sum to 272, which the batched
#: round pads to its bucket, 512)
LOOKUP_WIDTHS = (16, 32, 64, 16, 32, 64, 16, 32)
#: cell B: clients a tick, query nodes a client, ticks
GAT_CLIENTS, GAT_QUERY, GAT_TICKS = 16, 256, 4
#: float lookups on cell B's graph: solo widths of both kernel forms
#: (64 and 46 columns: 256 and 184 bytes a row) whose batch (110,
#: padded to 128) takes the bulk form, so batched == solo shows each
#: column's sum order holds across widths and forms
FORM_WIDTHS = (64, 46)


def exact_scores(torch, X, Y, rows, cols):
    """``<X_i, Y_j>`` at the (rows, cols) pairs, summed in float64 and
    cast: exact for integer-valued operands (every partial sum is an
    integer far below 2^24), so it holds a served score bit for bit."""
    r = torch.as_tensor(np.asarray(rows), device=X.device).long()
    c = torch.as_tensor(np.asarray(cols), device=Y.device).long()
    return (X[r].double() * Y[c].double()).sum(1).float()


def exact_spmm(torch, rows, cols, vals, W, m):
    """``S @ W`` summed in float64 and cast, in chunks of nonzeros (no
    (nnz, w) gather at once): exact for integer-valued data."""
    out = torch.zeros((m, W.shape[1]), dtype=torch.float64, device=W.device)
    step = 1 << 22
    for s in range(0, len(rows), step):
        out.index_add_(0, rows[s:s + step],
                       vals[s:s + step, None] * W[cols[s:s + step]].double())
    return out.float()


@contextlib.contextmanager
def counting_host_sums(api, calls):
    """Count the Session's fingerprints of numpy operands (a host sum of
    every entry) inside the block."""
    orig = api.Session.__dict__["_cheap_fp"]

    def spy(arr):
        if isinstance(arr, np.ndarray):
            calls.append(arr.shape)
        return orig.__func__(arr)

    api.Session._cheap_fp = staticmethod(spy)
    try:
        yield
    finally:
        api.Session._cheap_fp = orig


def score_trace(dep, conc, bursts, catalog):
    """bench_serving.py's open-loop trace: ``bursts`` bursts
    SERVE_PERIOD apart, ``conc`` score requests each, cycling through the
    catalog; returns (trace, catalog index of each request)."""
    from repro_torch.apps import als
    trace, order = [], []
    for b in range(bursts):
        for j in range(conc):
            k = (b * conc + j) % len(catalog)
            qr, qc = catalog[k]

            def submit(engine, arrival, qr=qr, qc=qc):
                return als.predict_scores(engine, dep, qr, qc,
                                          arrival=arrival)

            trace.append((b * SERVE_PERIOD, submit))
            order.append(k)
    return trace, order


def one_burst(serving, dep, eng, conc, catalog):
    """Submit one burst of ``conc`` score requests and tick (the
    device_breakdown unit)."""
    trace, _ = score_trace(dep, conc, 1, catalog)
    for arrival, submit in trace:
        submit(eng, arrival)
    return eng.tick()


def served_launches(total):
    """Add the launches since the last reset to ``total``, then reset."""
    from repro_torch.kernels import ops
    for k, v in ops.launch_counts().items():
        total[k] += v
    ops.reset_launch_counts()


def score_traffic(torch, ck, dep, pool, catalog, want, concurrency, total):
    """Replay the score traffic through the batched engine and the solo
    one (no coalescing, no Session) at each concurrency: every answer
    against the exact dots, batched == solo bit for bit; p50/p99,
    requests a second, ticks, rounds, launches and packing seconds of
    the measured replay, its Session hits and misses, the device split
    of one burst's tick and that tick's wall ms, and no operand summed
    on the host."""
    from repro_torch import serving
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics
    rows = []
    for conc in concurrency:
        got = {}
        for mode in ("batched", "solo"):
            batched = mode == "batched"
            eng = serving.ServingEngine(pool, max_batch=64,
                                        batching=batched,
                                        use_session=batched)
            serving.replay_trace(eng, score_trace(dep, conc, 2, catalog)[0])
            served_launches(total)
            trace, order = score_trace(dep, conc, SERVE_BURSTS, catalog)
            packs, sums = [], []
            rounds, sess = eng.rounds, dep.session.stats()
            with metrics.collect() as reg, \
                    counting_packs(torch, api, packs), \
                    counting_host_sums(api, sums):
                res = serving.replay_trace(eng, trace)
            launches, forms = ops.launch_counts(), ops.form_counts()
            served_launches(total)
            if sums:
                raise AssertionError(f"serving {mode} c{conc}: the Session "
                                     f"summed {len(sums)} host operands")
            if res["served"] != len(trace) or forms["sddmm"] == {}:
                raise AssertionError(f"serving {mode} c{conc}: served "
                                     f"{res['served']}, forms {forms}")
            for t, k in zip(res["tickets"], order):
                ck.equal(t.result(), want[k], f"serving {mode} c{conc} "
                         "score == exact")
            got[mode] = [t.result() for t in res["tickets"]]
            ticks = reg.value("serving.ticks")
            sh, sm = (dep.session.stats()[k] - sess[k]
                      for k in ("hits", "misses"))
            walls = [one_burst(serving, dep, eng, conc, catalog)["wall"]
                     for _ in range(3)]
            served_launches(total)
            rows.append(dict(
                mode=mode, concurrency=conc, served=res["served"],
                shed=res["shed"], p50_ms=res["p50"] * 1e3,
                p99_ms=res["p99"] * 1e3, requests_per_s=res["throughput"],
                ticks=ticks, rounds=eng.rounds - rounds,
                launches_per_tick={k: v / ticks for k, v in launches.items()},
                forms=forms, pack_s_per_tick=sum(packs) / ticks,
                tick_ms=statistics.median(walls) * 1e3,
                device=device_breakdown(torch, lambda: one_burst(
                    serving, dep, eng, conc, catalog)),
                session_hits=sh, session_misses=sm))
            ops.reset_launch_counts()
            log(f"serving p={dep.problem.p} {mode} c{conc}: "
                f"p50 {rows[-1]['p50_ms']:.2f} ms, p99 "
                f"{rows[-1]['p99_ms']:.2f} ms, "
                f"{rows[-1]['requests_per_s']:.0f} req/s")
        for a, b in zip(got["batched"], got["solo"]):
            ck.equal(a, b, f"serving c{conc}: batched == solo")
    return rows


def lookup_tick(torch, dep, pool, Ws, batching):
    """One tick of lookups (all of ``Ws``); (answers, tick ms,
    launches, forms)."""
    from repro_torch import serving
    from repro_torch.apps import als
    from repro_torch.kernels import ops
    eng = serving.ServingEngine(pool, max_batch=64, batching=batching,
                                use_session=batching)
    ops.reset_launch_counts()
    tickets = [als.lookup_embeddings(eng, dep, W) for W in Ws]
    rep = eng.tick()
    return ([t.result() for t in tickets], rep["wall"] * 1e3,
            ops.launch_counts(), ops.form_counts())


def serving_als(torch, ck, scale, total):
    """Cell A: CF prediction and lookups on the main configuration with
    integer data, deployed on SERVE_P stacked ranks ("auto"), then the
    recoveries, then the score traffic on one rank."""
    import gc
    import weakref
    from repro_torch import serving
    from repro_torch.apps import als
    from repro_torch.core import api
    from repro_torch.distributed import faults
    from repro_torch.serving import pool as pool_mod
    dev = torch.device("cuda")
    m, r = 1 << scale, 128
    t0 = time.perf_counter()
    rows, cols, vals, U, V = integer_problem(torch, m, 16, r, 0)
    report = {"m": m, "r": r, "nnz": int(len(vals)),
              "gen_s": time.perf_counter() - t0}
    digest_s = []
    pool8 = serving.SessionPool(capacity=2)
    with patched(pool_mod, "content_key", seconds_of(digest_s)):
        t0 = time.perf_counter()
        dep = als.deploy_factors(pool8, rows, cols, vals, (m, m), U, V,
                                 devices=[dev] * SERVE_P)
        torch.cuda.synchronize()
        report["deploy"] = {"seconds": time.perf_counter() - t0,
                            "digest_s": digest_s[0],
                            "family": dep.problem.alg.name,
                            "c": dep.problem.c, "p": dep.problem.p}
    rng = np.random.default_rng(3)
    catalog = [(rng.integers(0, m, SERVE_QUERY),
                rng.integers(0, m, SERVE_QUERY))
               for _ in range(SERVE_CATALOG)]
    want = [exact_scores(torch, U, V, qr, qc) for qr, qc in catalog]
    report["scores"] = score_traffic(torch, ck, dep, pool8, catalog, want,
                                     SERVE_CONCURRENCY, total)

    # lookups: one tick of all widths, batched against solo
    g = torch.Generator(device="cuda").manual_seed(5)
    Ws = [torch.randint(-3, 4, (m, w), generator=g, device=dev).float()
          for w in LOOKUP_WIDTHS]
    rows_t = torch.from_numpy(rows).to(dev).long()
    cols_t = torch.from_numpy(cols).to(dev).long()
    vals_t = torch.from_numpy(vals).to(dev).double()
    packs, look = [], {}
    for mode, batching in (("batched", True), ("solo", False)):
        with counting_packs(torch, api, packs):
            outs, ms, launches, forms = lookup_tick(torch, dep, pool8, Ws,
                                                    batching)
        served_launches(total)
        for W, out in zip(Ws, outs):
            ck.equal(out, exact_spmm(torch, rows_t, cols_t, vals_t, W, m),
                     f"lookup {mode} w={W.shape[1]} == exact")
        look[mode] = outs
        report.setdefault("lookups", {})[mode] = {
            "tick_ms": ms, "launches": launches, "forms": forms,
            "pack_s": list(packs)}
        packs.clear()
    for a, b in zip(look["batched"], look["solo"]):
        ck.equal(a, b, "lookups: batched == solo")
    del look, outs, Ws
    torch.cuda.empty_cache()

    # recoveries: a DeviceLost in a score tick (SERVE_P -> the largest
    # feasible p), then one in a lookup tick on the degraded grid
    eng = serving.ServingEngine(pool8, max_batch=64)
    recoveries = []
    W2 = torch.randint(-3, 4, (m, 16), generator=g, device=dev).float()
    for (op, rank), submit in zip(
            (("sddmm", SERVE_LOST[0]), ("spmm", SERVE_LOST[1])),
            (lambda: [als.predict_scores(eng, dep, *catalog[k])
                      for k in range(SERVE_CATALOG)],
             lambda: [als.lookup_embeddings(eng, dep, W2)])):
        plan = faults.FaultPlan.scripted(faults.FaultSpec(
            op=op, kind="device_lost", rank=rank, round=0))
        p_before = dep.problem.p
        with faults.inject(plan) as ctl:
            tickets = submit()
            wall = eng.tick()["wall"]
        served_launches(total)
        rec = dep.elastic.recoveries[-1]
        if len(ctl.fired) != 1 or dep.problem.p >= p_before \
                or rec["remeshed_to_p"] != dep.problem.p:
            raise AssertionError(f"serving recovery {op}: fired "
                                 f"{ctl.fired}, {rec}")
        for k, t in enumerate(tickets):
            ck.equal(t.result(), want[k] if op == "sddmm" else exact_spmm(
                torch, rows_t, cols_t, vals_t, W2, m),
                f"serving recovery {op}: answer == exact")
        recoveries.append({"op": op, "lost_rank": rank, "p": p_before,
                           "p_after": dep.problem.p,
                           "family_after": dep.problem.alg.name,
                           "c_after": dep.problem.c, "tick_ms": wall * 1e3})
        log(f"serving: DeviceLost({rank}) in {op}: p {p_before} -> "
            f"{dep.problem.p}, tick {wall * 1e3:.0f} ms")
    # two score ticks on the degraded grid: the first re-warms the
    # Session there (misses), the second hits it
    steady = []
    for _ in range(2):
        tickets = [als.predict_scores(eng, dep, *catalog[k])
                   for k in range(SERVE_CATALOG)]
        wall = eng.tick()["wall"]
        served_launches(total)
        for k, t in enumerate(tickets):
            ck.equal(t.result(), want[k], "serving after recoveries == exact")
        steady.append({"tick_ms": wall * 1e3,
                       "session": dep.session.stats()})
    if steady[1]["session"]["hits"] <= steady[0]["session"]["hits"]:
        raise AssertionError(f"serving: no Session hit after re-warming "
                             f"{steady}")
    report["recoveries"] = {"events": recoveries, "steady": steady}
    report["pool"] = pool8.stats()
    del tickets, dep, eng, pool8, rows_t, cols_t, vals_t, W2
    torch.cuda.empty_cache()

    # the same score traffic at p = 1 ("auto"), in a pool of one
    pool1 = serving.SessionPool(capacity=1)
    digest_s.clear()
    with patched(pool_mod, "content_key", seconds_of(digest_s)):
        t0 = time.perf_counter()
        dep1 = als.deploy_factors(pool1, rows, cols, vals, (m, m), U, V)
        report["deploy_p1"] = {"seconds": time.perf_counter() - t0,
                               "digest_s": digest_s[0],
                               "family": dep1.problem.alg.name,
                               "c": dep1.problem.c}
    report["scores_p1"] = score_traffic(torch, ck, dep1, pool1, catalog,
                                        want, SERVE_CONCURRENCY, total)
    # eviction frees the deployment at once: no reference cycle holds it
    gone = [weakref.ref(dep1.problem), weakref.ref(dep1.operand("U"))]
    del dep1
    gc.collect()
    torch.cuda.empty_cache()
    small = integer_problem(torch, 1 << 10, 4, 8, 1)[:3]
    gc.disable()
    try:
        held = torch.cuda.memory_allocated()
        pool1.deploy(*small, (1 << 10, 1 << 10), 8)
        freed = held - torch.cuda.memory_allocated()
        if any(w() is not None for w in gone) or pool1.evictions != 1:
            raise AssertionError("serving: the evicted deployment outlived "
                                 "its eviction")
        ck.n += 1
    finally:
        gc.enable()
    report["eviction_freed_gib"] = freed / 2**30
    return report


def serving_gat(torch, ck, scale, total):
    """Cell B: GAT inference on 2^scale nodes (16 neighbours + self
    loops), d = 128, one head, on one card ("auto"): GAT_CLIENTS clients
    of GAT_QUERY nodes a tick, each tick's rows bit for bit the port's
    full distributed layer and within 2e-3 of its plain version (the
    first tick packs the aggregation's plan and is left out of the
    latencies); then float lookups batched against solo across widths
    and forms."""
    import torch.nn.functional as F
    from repro_torch import serving
    from repro_torch.apps import gat
    from repro_torch.core import api
    from repro_torch.kernels import ops
    from repro_torch.serving import pool as pool_mod
    dev = torch.device("cuda")
    m, d = 1 << scale, 128
    t0 = time.perf_counter()
    rows, cols = gat_graph_on_card(torch, m, 16, 0)
    g = torch.Generator(device="cuda").manual_seed(2)
    H = torch.randn((m, d), generator=g, device="cuda")
    params = gat.init_gat_layer(
        torch.Generator(device="cuda").manual_seed(0), d, d)
    report = {"m": m, "d": d, "nnz": int(len(rows)),
              "gen_s": time.perf_counter() - t0}
    pool = serving.SessionPool(capacity=1)
    digest_s = []
    with patched(pool_mod, "content_key", seconds_of(digest_s)):
        t0 = time.perf_counter()
        dep = gat.gat_deploy_layer(pool, rows, cols, m, H, params)
        torch.cuda.synchronize()
        deploy_s = time.perf_counter() - t0
        if gat.gat_deploy_layer(pool, rows, cols, m, H, params) is not dep:
            raise AssertionError("serving GAT: an identical re-deploy "
                                 "missed the pool")
    report["deploy"] = {"seconds": deploy_s, "digest_s": digest_s,
                        "family": dep.problem.alg.name, "c": dep.problem.c,
                        "pool": pool.stats()}
    graphP = api.make_problem(rows, cols, np.ones(len(rows), np.float32),
                              (m, m), d)
    full = gat.gat_layer_distributed(graphP, H, params)
    ops.set_default_backend("ref")
    try:
        plain = gat.gat_layer_distributed(graphP, H, params)
    finally:
        ops.set_default_backend("cuda")
    ops.reset_launch_counts()
    eng = serving.ServingEngine(pool, max_batch=64)
    rng = np.random.default_rng(4)
    ticks, worst = [], 0.0
    for _ in range(1 + GAT_TICKS):        # the first packs the SpMM plan
        clients = [np.sort(rng.choice(m, GAT_QUERY, replace=False))
                   for _ in range(GAT_CLIENTS)]
        t0 = time.perf_counter()
        scores = [gat.gat_submit_scores(eng, dep, ids)[0] for ids in clients]
        rep1 = eng.tick()
        aggs = [gat.gat_submit_aggregate(eng, dep, ids, t.result())
                for ids, t in zip(clients, scores)]
        rep2 = eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for ids, t in zip(clients, aggs):
            idx = torch.from_numpy(ids).to(dev)
            got = F.elu(t.result())[idx]
            ck.equal(got, full[idx], "served GAT rows == distributed layer")
            worst = max(worst, ck.close(got, plain[idx], 2e-3,
                                        "served GAT rows vs plain"))
        ticks.append({"score_tick_ms": rep1["wall"] * 1e3,
                      "aggregate_tick_ms": rep2["wall"] * 1e3,
                      "rounds": [rep1["rounds"], rep2["rounds"]],
                      "query_ms": wall * 1e3})
        del scores, aggs
    launches, forms = ops.launch_counts(), ops.form_counts()
    served_launches(total)
    if not (forms["sddmm"] and forms["spmm"]):
        raise AssertionError(f"serving GAT: kernels not launched: {forms}")
    qms = sorted(t["query_ms"] for t in ticks[1:])
    report["queries"] = {
        "ticks": ticks, "p50_ms": float(np.percentile(qms, 50)),
        "p99_ms": float(np.percentile(qms, 99)),
        "requests_per_s": GAT_CLIENTS * len(qms) / (sum(qms) / 1e3),
        "launches_per_query_tick": {k: v / len(ticks)
                                    for k, v in launches.items()},
        "forms": forms, "max_abs_err_vs_plain": worst,
        "session": dep.session.stats()}

    # float lookups: batched (one bulk-form round) == solo (a bulk and a
    # load round) bit for bit
    Ws = [torch.randn((m, w), generator=g, device=dev) for w in FORM_WIDTHS]
    look = {}
    for mode, batching in (("batched", True), ("solo", False)):
        outs, ms, launches, forms = lookup_tick(torch, dep, pool, Ws,
                                                batching)
        served_launches(total)
        look[mode] = outs
        report.setdefault("form_lookups", {})[mode] = {
            "tick_ms": ms, "forms": forms}
    for a, b in zip(look["batched"], look["solo"]):
        ck.equal(a, b, "float lookups: batched == solo across forms")
    if set(report["form_lookups"]["solo"]["forms"]["spmm"]) != \
            {"bulk", "load"}:
        raise AssertionError(f"float lookups: forms {report['form_lookups']}")
    return report


def phase_serving(torch, scale: int, apps_scale: int):
    """The serving engine on the card: cell A (CF prediction and lookups
    at the main configuration, integer data, p = 8 stacked, recoveries,
    p = 1) and cell B (GAT inference at 2^apps_scale nodes).  Returns the
    launches of the served traffic."""
    from repro_torch.kernels import ops
    ck = Checker(torch)
    total = {k: 0 for k in ops.KERNELS}
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = {"phase": "serving", "device": torch.cuda.get_device_name(0)}
    report["als"] = serving_als(torch, ck, scale, total)
    report["seconds_als"] = time.perf_counter() - t0
    report["gat"] = serving_gat(torch, ck, apps_scale, total)
    for k in ("sddmm", "spmm"):
        if total[k] <= 0:
            raise AssertionError(f"serving: {k} kernel not launched: {total}")
    report.update(launches=total, checks=ck.n,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  seconds=time.perf_counter() - t0)
    emit(report)
    return total


# ---------------------------------------------------------------------------
# the LM zoo's serving path
# ---------------------------------------------------------------------------

LM_SERVE = ["--batches", "2", "--batch", "4", "--prompt-len", "16",
            "--gen", "16"]
LM_TF_TOL = 5e-3        # teacher forcing, tests/test_serving.py:45
LM_CPU_TOL = 1e-3       # the card against the same model on the CPU
LM_REDUCED_TOL = 1e-4   # the reduced configs, card against CPU
LM_MOE_TOL = 2e-4       # dispatch="spmm" against "einsum", test_models.py
LM_MOE_TOKENS = (4, 512)


def cpu_copy(torch, cfg, model):
    """The same model on the CPU (each weight copied with ``.to``)."""
    from repro_torch.models import model as M
    cpu = M.empty_model(cfg)
    cpu.load_state_dict({k: v.to("cpu") for k, v in
                         model.state_dict().items()}, assign=True)
    return cpu


def cache_bytes(cache):
    """Bytes of a cache's leaves but the fill counters ("pos")."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for k, v in cache.items() if k != "pos")
    if isinstance(cache, list):
        return sum(cache_bytes(v) for v in cache)
    return cache.numel() * cache.element_size()


def lm_serve(torch, cfg, argv=None, caches=False):
    """``launch.serve.main(argv)`` (LM_SERVE by default) with ``cfg`` in
    place of the arch's: returns the model it drew (``init_sharded``),
    the mesh it made, each batch's JSON line, and each prefill's and
    decode step's tokens, logits and host seconds (the card synchronised
    before the clock is read, as serve does); with ``caches`` each
    call's cache bytes too (``prefill_cache``, ``decode_cache``)."""
    import io
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import decode
    rec = {"models": [], "meshes": [], "prefill": [], "decode": [],
           "prefill_cache": [], "decode_cache": []}

    def keeping(key):
        def wrap(orig):
            def make(*a, **k):
                rec[key].append(orig(*a, **k))
                return rec[key][-1]
            return make
        return wrap

    def recording(key):
        def wrap(orig):
            def step(cfg_, pcfg, model, batch, *rest):
                t0 = time.perf_counter()
                logits, cache = orig(cfg_, pcfg, model, batch, *rest)
                torch.cuda.synchronize()
                rec[key].append((batch["tokens"], logits,
                                 time.perf_counter() - t0))
                if caches:
                    rec[key + "_cache"].append(cache_bytes(cache))
                return logits, cache
            return step
        return wrap

    out = io.StringIO()
    with contextlib.ExitStack() as st:
        st.enter_context(patched(M, "init_sharded", keeping("models")))
        st.enter_context(patched(serve, "make_local_mesh",
                                 keeping("meshes")))
        st.enter_context(patched(decode, "prefill", recording("prefill")))
        st.enter_context(patched(decode, "decode_step",
                                 recording("decode")))
        st.enter_context(patched(serve, "resolve_config",
                                 lambda orig: lambda arch, smoke: cfg))
        st.enter_context(contextlib.redirect_stdout(out))
        rc = serve.main(LM_SERVE if argv is None else argv)
    lines = out.getvalue().splitlines()
    for ln in lines:
        log(f"[serve {cfg.name}] {ln}")
    if rc != 0 or not lines or lines[-1] != "SERVING DONE":
        raise AssertionError(f"lm: serve exited {rc}: {lines[-3:]}")
    rec["lines"] = [json.loads(ln) for ln in lines[:-1]]
    return rec


def _per_batch(rec, key):
    n = len(rec["prefill"])
    steps = len(rec[key]) // n
    return [rec[key][b * steps:(b + 1) * steps] for b in range(n)]


def lm_report(rec):
    """Each batch's JSON line with its wall seconds (prefill and every
    decode step) and tokens a second."""
    out = []
    for line, pre, dec in zip(rec["lines"], rec["prefill"],
                              _per_batch(rec, "decode")):
        wall = pre[2] + sum(s for _, _, s in dec)
        out.append({**line, "wall_s": wall,
                    "tokens_per_s": line["tokens"] / wall})
    return out


def lm_teacher_forcing(torch, ck, cfg, pcfg, model, rec):
    """Each batch's prefill and decode logits against one full forward
    of the same tokens on the card; returns the largest error.  Where
    ``cfg`` has a Mamba layer, the forward's tokens are padded at the end
    to a multiple of its SSD chunk, which the earlier positions of a
    causal model do not read."""
    from repro_torch.models import model as M
    mamba = any(sp.mixer == "mamba" for sb, _ in cfg.segments for sp in sb)
    multiple = cfg.ssm_chunk if mamba else 1
    err = 0.0
    for (prompt, logits_p, _), dec in zip(rec["prefill"],
                                          _per_batch(rec, "decode")):
        toks = torch.cat([prompt] + [t for t, _, _ in dec], dim=1)
        pad = -toks.shape[1] % multiple
        toks = torch.cat([toks, toks.new_zeros((toks.shape[0], pad))], 1)
        with torch.inference_mode():
            full, _, _ = M.forward(cfg, pcfg, model, {"tokens": toks},
                                   want_cache=False)
        s0 = prompt.shape[1]
        err = max(err, ck.close(logits_p[:, -1], full[:, s0 - 1],
                                LM_TF_TOL, f"lm {cfg.name} prefill"))
        for i, (_, logits, _) in enumerate(dec):
            err = max(err, ck.close(logits[:, 0], full[:, s0 + i],
                                    LM_TF_TOL,
                                    f"lm {cfg.name} decode step {i}"))
    return err


def lm_against_cpu(torch, ck, cfg, pcfg, model, rec, decode_batches):
    """The prefill logits of every batch, and the decode logits of the
    first ``decode_batches`` batches fed the card's tokens, against the
    same model on the CPU; returns (largest error, CPU seconds)."""
    from repro_torch.serving import decode
    t0 = time.perf_counter()
    cpu = cpu_copy(torch, cfg, model)
    err = 0.0
    for b, ((prompt, logits_p, _), dec) in enumerate(
            zip(rec["prefill"], _per_batch(rec, "decode"))):
        want, cache = decode.prefill(cfg, pcfg, cpu,
                                     {"tokens": prompt.cpu()})
        err = max(err, ck.close(logits_p.cpu(), want, LM_CPU_TOL,
                                f"lm {cfg.name} prefill, card vs CPU"))
        if b >= decode_batches:
            continue
        cache = decode.extend_cache(cache, len(dec))
        for i, (tok, logits, _) in enumerate(dec):
            want, cache = decode.decode_step(cfg, pcfg, cpu,
                                             {"tokens": tok.cpu()}, cache)
            err = max(err, ck.close(logits.cpu(), want, LM_CPU_TOL,
                                    f"lm {cfg.name} decode step {i}, "
                                    f"card vs CPU"))
    return err, time.perf_counter() - t0


def lm_full(torch, ck, cfg, pcfg, teacher, decode_batches):
    """Serve ``cfg`` through launch.serve on the card and check it;
    returns (report, the model)."""
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = lm_serve(torch, cfg)
    report = {"arch": cfg.name, "params": cfg.param_count(),
              "d_model": cfg.d_model, "layers": cfg.n_layers,
              "batches": lm_report(rec),
              "serve_s": time.perf_counter() - t0,
              # the serve's own peak, above what earlier phases hold
              "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
              "held_gib": held / 2**30,
              "serve_launches": ops.launch_counts()}
    model = rec["models"][0]
    if teacher:
        report["teacher_forcing_err"] = lm_teacher_forcing(
            torch, ck, cfg, pcfg, model, rec)
    report["cpu_err"], report["cpu_s"] = lm_against_cpu(
        torch, ck, cfg, pcfg, model, rec, decode_batches)
    return report, model


def lm_moe_packs(torch, ck, cfg, layer, x, reps, rank=0, shares=1):
    """The dispatch and combine packs of one routing of ``x`` (of
    expert-parallel share ``rank`` of ``shares``: its experts' slots,
    ``moe.moe_share``): the kernel against its plain version on the same
    inputs, its ms, bound, plain ms and ``torch.sparse.mm``'s (CSR)
    ms."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm import spmm_cuda
    from repro_torch.models import moe as MOE
    E, d = cfg.moe_experts, cfg.d_model
    xf = x.reshape(-1, d)
    _, _, gate_v, slot, keep, C, _ = MOE.route(cfg, layer, xf)
    rows = E // shares * C
    if shares > 1:
        lo = rank * rows
        keep = keep & (slot >= lo) & (slot < lo + rows)
        slot = torch.where(keep, slot - lo, 0)
    g = torch.Generator(device="cuda").manual_seed(6)
    y = torch.randn((rows, d), generator=g, device="cuda")
    packs = {"dispatch": (MOE.dispatch_pack(slot, keep, xf.shape[0], rows,
                                            xf.dtype), xf),
             "combine": (MOE.combine_pack(slot, gate_v * keep, rows), y)}
    out = {}
    for name, (S, Bd) in packs.items():
        m = S.shape[0]

        def kern(S=S, Bd=Bd, m=m):
            return ops.spmm(S, Bd, m=m, r_tile=d, blocks_per_step=1)

        def plain(S=S, Bd=Bd, m=m):
            return ops.spmm(S, Bd, m=m, backend="ref")
        coo = S.to_padded_coo()
        with warnings.catch_warnings():   # sparse CSR is "beta" in torch
            warnings.simplefilter("ignore", UserWarning)
            sp = torch.sparse_coo_tensor(
                torch.stack([coo.rows.long(), coo.cols.long()]), coo.vals,
                (m, Bd.shape[0])).coalesce().to_sparse_csr()
        bound = _bound(torch, S, d, m, "spmm")
        out[name] = {
            "m": m, "n": Bd.shape[0], "r": d, "nnz": bound[5],
            "slots": S.rows_local.numel(), "row_tile": S.row_tile,
            "max_abs_err": ck.close(kern(), plain(), 2e-3,
                                    f"lm moe {name} kernel vs plain"),
            "form": spmm_cuda.last_form,
            "ms": time_ms(torch, kern, reps),
            "plain_ms": time_ms(torch, plain, reps),
            "library_ms": time_ms(torch, lambda sp=sp, Bd=Bd:
                                  torch.sparse.mm(sp, Bd), reps),
            "bound_ms": bound[0], "bound_by": bound[1]}
    return out


def lm_moe_layer(torch, ck, cfg, pcfg, layer, reps):
    """One MoE layer at LM_MOE_TOKENS tokens: dispatch="spmm" (the
    Hopper SpMM) against "einsum", the SpMM launches and forms of one
    counted call, both calls' ms, and each pack's kernel; returns
    (report, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    B, S = LM_MOE_TOKENS
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((B, S, cfg.d_model), generator=g, device="cuda")
    with torch.inference_mode():
        want, _ = MOE.moe(cfg, pcfg, layer, x, dispatch="einsum")
        ops.reset_launch_counts()
        got, _ = MOE.moe(cfg, pcfg, layer, x, dispatch="spmm")
        torch.cuda.synchronize()
        launches, forms = ops.launch_counts(), ops.form_counts()
        err = ck.close(got, want, LM_MOE_TOL, "lm moe spmm vs einsum")
        if launches["spmm"] != 2 or forms["spmm"].get("bulk", 0) != 2:
            raise AssertionError(f"lm moe: expected 2 bulk SpMM launches, "
                                 f"got {launches} {forms}")
        report = {"tokens": B * S, "experts": cfg.moe_experts,
                  "top_k": cfg.moe_top_k,
                  "capacity": int(cfg.capacity_factor * B * S
                                  * cfg.moe_top_k / cfg.moe_experts),
                  "launches": launches, "forms": forms, "err": err,
                  "spmm_ms": time_ms(torch, lambda: MOE.moe(
                      cfg, pcfg, layer, x, dispatch="spmm"), reps),
                  "einsum_ms": time_ms(torch, lambda: MOE.moe(
                      cfg, pcfg, layer, x, dispatch="einsum"), reps),
                  "packs": lm_moe_packs(torch, ck, cfg, layer, x, reps)}
    return report, launches


def lm_reduced(torch, ck, pcfg):
    """Every registered architecture's reduced config on the card
    against the same model on the CPU: prefill of 2 x 16 and 2 decode
    steps (HuBERT, an encoder: the forward alone)."""
    from repro_torch.launch.train import SMOKE_MODULES, resolve_config
    from repro_torch.models import model as M
    from repro_torch.serving import decode
    out = {}
    for arch in SMOKE_MODULES:
        cfg = resolve_config(arch, True)
        g = torch.Generator(device="cuda").manual_seed(3)
        model = M.init_params(cfg, g, device="cuda")
        cpu = cpu_copy(torch, cfg, model)
        rng = np.random.default_rng(4)

        def batch_of(n, first, cfg=cfg, rng=rng):
            if cfg.embed_inputs:
                return {"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab, (2, n)))}
            b = {"embeds": torch.as_tensor(
                rng.standard_normal((2, n, cfg.d_model)),
                dtype=torch.float32)}
            if cfg.pos_dims == 3 and first:
                b["positions"] = torch.as_tensor(
                    rng.integers(0, n, (2, n, 3)))
            return b

        def on_card(batch):
            return {k: v.to("cuda") for k, v in batch.items()}
        b0 = batch_of(16, True)
        if not cfg.causal:
            with torch.inference_mode():
                got, _, _ = M.forward(cfg, pcfg, model, on_card(b0),
                                      want_cache=False)
                want, _, _ = M.forward(cfg, pcfg, cpu, b0, want_cache=False)
            out[arch] = {"err": ck.close(got.cpu(), want, LM_REDUCED_TOL,
                                         f"lm {arch} forward"),
                         "decode_steps": 0}
            continue
        got, c_card = decode.prefill(cfg, pcfg, model, on_card(b0))
        want, c_cpu = decode.prefill(cfg, pcfg, cpu, b0)
        err = ck.close(got.cpu(), want, LM_REDUCED_TOL, f"lm {arch} prefill")
        c_card = decode.extend_cache(c_card, 2)
        c_cpu = decode.extend_cache(c_cpu, 2)
        for i in range(2):
            step = ({"tokens": got[:, -1].argmax(-1)[:, None].cpu()}
                    if cfg.embed_inputs else batch_of(1, False))
            got, c_card = decode.decode_step(cfg, pcfg, model,
                                             on_card(step), c_card)
            want, c_cpu = decode.decode_step(cfg, pcfg, cpu, step, c_cpu)
            err = max(err, ck.close(got.cpu(), want, LM_REDUCED_TOL,
                                    f"lm {arch} decode step {i}"))
        out[arch] = {"err": err, "decode_steps": 2}
    return out


def deepseek_cut():
    """(DeepSeek-V2-Lite at full width with its depth cut to the dense
    layer and 3 MoE layers, the full config)."""
    import dataclasses
    from repro_torch.config import get_config
    from repro_torch.configs import deepseek_v2_lite_16b as ds
    full = get_config("deepseek-v2-lite-16b")
    return dataclasses.replace(
        full, name="deepseek-v2-lite-16b-cut",
        segments=(((ds.DENSE0,), 1), ((ds.MOE,), 3))), full


def phase_lm(torch, reps: int):
    """The LM zoo's serving path on the card: (C) every reduced config
    against the CPU, (A) llama3.2-1b at full width and depth through
    launch.serve, (B) DeepSeek-V2-Lite at full width (depth cut) through
    launch.serve and one MoE layer's SpMM dispatch.  Returns the
    launches of the counted SpMM dispatch."""
    from repro_torch.config import ParallelConfig, get_config
    ck = Checker(torch)
    pcfg = ParallelConfig(compute_dtype="float32")
    t0 = time.perf_counter()
    report = {"phase": "lm", "device": torch.cuda.get_device_name(0),
              "reduced": lm_reduced(torch, ck, pcfg)}
    report["seconds_reduced"] = time.perf_counter() - t0
    report["llama"], model = lm_full(torch, ck, get_config("llama3.2-1b"),
                                     pcfg, teacher=True, decode_batches=2)
    del model
    report["seconds_llama"] = time.perf_counter() - t0
    cut, full = deepseek_cut()
    report["deepseek"], model = lm_full(torch, ck, cut, pcfg,
                                        teacher=False, decode_batches=1)
    report["deepseek"]["cut"] = (
        f"layers {full.n_layers} -> {cut.n_layers} (the dense layer 0 and "
        f"3 MoE layers), params {full.param_count()} -> "
        f"{cut.param_count()}")
    report["moe_layer"], launches = lm_moe_layer(
        torch, ck, cut, pcfg, model.segments[1][0].blk0.moe, reps)
    del model
    torch.cuda.empty_cache()
    report.update(launches=launches, checks=ck.n,
                  seconds=time.perf_counter() - t0)
    emit(report)
    return launches


# ---------------------------------------------------------------------------
# the LM zoo's training path
# ---------------------------------------------------------------------------

#: (A) launch.train.main at its defaults (--seq 512 --batch 8), 4 steps
TRAIN_LM_ARGS = ["--steps", "4", "--log-every", "1"]
TRAIN_LM_LOSS0 = 0.10       # step 0's loss within 10% of ln(vocab)
TRAIN_LM_RESUME_TOL = 1e-6  # tests/test_training.py's exact resume
TRAIN_LM_CUT_LAYERS = 2     # (A2)'s depth
TRAIN_LM_MOE_TOL = 1e-3     # (B) spmm vs einsum, of each leaf's largest
TRAIN_LM_CPU_TOL = 1e-4     # (C) card vs CPU: loss, grads of each leaf's max
TRAIN_LM_AUX = 0.01         # lm_loss's aux_weight


def lm_train(torch, cfg, argv):
    """``launch.train.main(argv)`` with ``cfg`` in place of the arch's:
    returns {"model", "state": the last run's model and optimizer state,
    "lines": its JSON lines, "text": every line, "step_s": each step's
    seconds as its StepMonitor saw them (the card synchronised)}."""
    import io
    from repro_torch.distributed.elastic import StepMonitor
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    rec = {"model": None, "state": None, "step_s": []}

    def keep(key):
        def wrap(orig):
            def made(*a, **k):
                rec[key] = orig(*a, **k)
                return rec[key]
            return made
        return wrap

    def timing(orig):
        def observe(self, step, seconds):
            rec["step_s"].append(seconds)
            return orig(self, step, seconds)
        return observe

    out = io.StringIO()
    with contextlib.ExitStack() as st:
        st.enter_context(patched(M, "init_sharded", keep("model")))
        st.enter_context(patched(opt, "init_opt_state", keep("state")))
        st.enter_context(patched(StepMonitor, "observe", timing))
        st.enter_context(patched(train, "resolve_config",
                                 lambda orig: lambda arch, smoke: cfg))
        st.enter_context(contextlib.redirect_stdout(out))
        rc = train.main(argv)
    rec["text"] = out.getvalue().splitlines()
    for ln in rec["text"]:
        log(f"[train {cfg.name}] {ln}")
    if rc != 0 or not rec["text"] or rec["text"][-1] != "TRAINING DONE":
        raise AssertionError(f"train_lm: train exited {rc}: "
                             f"{rec['text'][-3:]}")
    rec["lines"] = [json.loads(ln) for ln in rec["text"]
                    if ln.startswith("{")]
    return rec


def train_lm_full(torch, ck):
    """(A) llama3.2-1b at full width and depth through launch.train.main
    at its defaults, 4 steps."""
    from repro_torch.config import get_config
    cfg = get_config("llama3.2-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rec = lm_train(torch, cfg, TRAIN_LM_ARGS)
    wall = time.perf_counter() - t0
    lines, state = rec["lines"], rec["state"]
    if [ln["step"] for ln in lines] != [0, 1, 2, 3]:
        raise AssertionError(f"train_lm (A): steps {lines}")
    for ln in lines:
        if not (np.isfinite(ln["loss"]) and np.isfinite(ln["grad_norm"])):
            raise AssertionError(f"train_lm (A): not finite {ln}")
    ln_v = float(np.log(cfg.vocab))
    if abs(lines[0]["loss"] - ln_v) > TRAIN_LM_LOSS0 * ln_v:
        raise AssertionError(f"train_lm (A): step 0's loss "
                             f"{lines[0]['loss']} not within 10% of "
                             f"ln(vocab) {ln_v}")
    if int(state["step"]) != 4:
        raise AssertionError(f"train_lm (A): opt step {int(state['step'])}")
    ck.n += 3
    n = sum(p.numel() for p in rec["model"].parameters())
    step_ms = [t * 1e3 for t in rec["step_s"]]
    med = statistics.median(step_ms[1:])
    batch, seq = 8, 512
    report = {"arch": cfg.name, "params": n, "layers": cfg.n_layers,
              "seq": seq, "batch": batch, "lines": lines, "step_ms": step_ms,
              "median_step_ms": med, "tokens_per_s": batch * seq / med * 1e3,
              "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
              "state_gib": 4 * n * 4 / 2**30, "wall_s": wall}
    del rec
    torch.cuda.empty_cache()
    return report


def train_lm_resume(torch, ck):
    """(A2) llama3.2-1b at full width, depth cut: 6 steps straight
    against 3 steps, a checkpoint, main resuming and 3 more."""
    import shutil
    import tempfile
    from repro_torch.config import get_config
    full = get_config("llama3.2-1b")
    cut = _llama_cut(TRAIN_LM_CUT_LAYERS)
    args = ["--log-every", "1"]
    t0 = time.perf_counter()
    straight = lm_train(torch, cut, ["--steps", "6"] + args)
    d = tempfile.mkdtemp(prefix="train_lm_ckpt")
    try:
        first = lm_train(torch, cut, ["--steps", "3", "--ckpt-dir", d]
                         + args)
        del first
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        resumed = lm_train(torch, cut, ["--steps", "6", "--ckpt-dir", d]
                           + args)
        t_resume = time.perf_counter() - t1
        ckpt_gib = sum(f.stat().st_size for f in pathlib.Path(d).rglob("*")
                       if f.is_file()) / 2**30
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if resumed["text"][0] != "resumed from step 3" or \
            int(resumed["state"]["step"]) != 6:
        raise AssertionError(f"train_lm (A2): {resumed['text'][:2]}, step "
                             f"{int(resumed['state']['step'])}")
    err = 0.0
    want = dict(straight["model"].named_parameters())
    for name, p in resumed["model"].named_parameters():
        err = max(err, ck.close(p.detach(), want[name].detach(),
                                TRAIN_LM_RESUME_TOL,
                                f"train_lm (A2) {name}"))
    report = {"cut": f"layers {full.n_layers} -> {cut.n_layers}, params "
                     f"{full.param_count()} -> {cut.param_count()}",
              "max_abs_err": err, "resume_s": t_resume,
              "checkpoint_gib": ckpt_gib,
              "losses": [ln["loss"] for ln in straight["lines"]],
              "resumed_losses": [ln["loss"] for ln in resumed["lines"]],
              "seconds": time.perf_counter() - t0}
    del straight, resumed
    torch.cuda.empty_cache()
    return report


def train_lm_remat(torch, ck):
    """(E) llama3.2-1b at full width, depth cut to TRAIN_LM_CUT_LAYERS,
    through launch.train.main: 2 steps with --remat full against 2
    without, every loss and every gradient leaf the optimizer is given
    equal bit for bit; each run's memory peak and step ms."""
    from repro_torch.training import optimizer as opt
    cut = _llama_cut(TRAIN_LM_CUT_LAYERS)
    t0 = time.perf_counter()
    runs = {}
    for remat in ("none", "full"):
        seen = []

        def spy(orig, seen=seen):
            def update(cfg_, params, grads, state, **kw):
                seen.append({k: v.detach().clone() for k, v in grads.items()})
                return orig(cfg_, params, grads, state, **kw)
            return update
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with patched(opt, "adamw_update", spy):
            rec = lm_train(torch, cut, ["--steps", "2", "--log-every", "1",
                                        "--remat", remat])
        runs[remat] = {"losses": [ln["loss"] for ln in rec["lines"]],
                       "grads": seen,
                       "step_ms": [t * 1e3 for t in rec["step_s"]],
                       "peak_gib": (torch.cuda.max_memory_allocated()
                                    - held) / 2**30}
        del rec
    a, b = runs["none"], runs["full"]
    if a["losses"] != b["losses"] or len(a["losses"]) != 2:
        raise AssertionError(f"train_lm (E): losses {a['losses']} without "
                             f"remat, {b['losses']} with")
    ck.n += 1
    for i, (ga, gb) in enumerate(zip(a["grads"], b["grads"])):
        for k, g in ga.items():
            if not torch.equal(g, gb[k]):
                raise AssertionError(f"train_lm (E): step {i} gradient {k} "
                                     f"differs under remat")
    ck.n += 1
    report = {"cut": cut.name, "steps": 2, "losses": a["losses"],
              "leaves": len(a["grads"][0]),
              **{f"{r}_{k}": v[k] for r, v in runs.items()
                 for k in ("peak_gib", "step_ms")},
              "seconds": time.perf_counter() - t0}
    del runs, a, b
    torch.cuda.empty_cache()
    return report


def _leaf_check(ck, got, want, tol, what):
    """Each leaf of ``got`` within ``tol`` of the largest magnitude of
    the same leaf of ``want``; returns {leaf: error / that magnitude}."""
    out = {}
    for k, w in want.items():
        g = got[k]
        if g is None or g.shape != w.shape or not bool(
                g.isfinite().all()):
            raise AssertionError(f"{what} {k}: missing, misshapen or not "
                                 f"finite")
        scale = max(float(w.abs().max()), 1e-12)
        err = float((g.float() - w.float()).abs().max())
        if err > tol * scale:
            raise AssertionError(f"{what} {k}: error {err:.3g} beyond "
                                 f"{tol} x {scale:.3g}")
        ck.n += 1
        out[k] = err / scale
    return out


def train_lm_moe_kernels(torch, ck, cfg, layer, x, dout, reps, rank=0,
                         shares=1, group=None):
    """The dispatch backward's three launches at the layer's shapes (of
    expert-parallel share ``rank`` of ``shares``: its experts' slots,
    ``moe.moe_share``; routed over the data-parallel ``group``, as the
    layer's tokens are): dx = D^T dbuf and dy = G^T dout (SpMM), d(gate)
    (SDDMM on G's pattern): each kernel against its plain version, its
    ms, bound, plain ms and the library call's ms."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    E, d = cfg.moe_experts, cfg.d_model
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    with torch.no_grad():
        _, _, gate_v, slot, keep, C, _ = MOE.route(cfg, layer, xf, group)
    m = E // shares * C
    lo = rank * m
    keep = keep & (slot >= lo) & (slot < lo + m)
    slot = torch.where(keep, slot - lo, 0)
    g = torch.Generator(device="cuda").manual_seed(8)
    dbuf = torch.randn((m, d), generator=g, device="cuda")
    y = torch.randn((m, d), generator=g, device="cuda")
    gates = (gate_v * keep).float()
    DT = MOE.combine_pack(slot, keep.float(), m)
    GT = MOE.dispatch_pack(slot, keep, T, m, torch.float32, gates=gates)
    A = torch.zeros((DT.shape[0], d), device="cuda")
    A[:T] = dout.reshape(T, d)
    out = {}

    def csr_of(S, n):
        coo = S.to_padded_coo()
        with warnings.catch_warnings():   # sparse CSR is "beta" in torch
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_coo_tensor(
                torch.stack([coo.rows.long(), coo.cols.long()]), coo.vals,
                (S.shape[0], n)).coalesce().to_sparse_csr()

    for name, S, Bd in (("dx", DT, dbuf), ("dy", GT, A[:T])):
        mo = S.shape[0]
        Bd = Bd.contiguous()
        sp = csr_of(S, Bd.shape[0])

        def kern(S=S, Bd=Bd, mo=mo):
            return ops.spmm(S, Bd, m=mo, r_tile=d, blocks_per_step=1)

        def plain(S=S, Bd=Bd, mo=mo):
            return ops.spmm(S, Bd, m=mo, backend="ref")
        bound = _bound(torch, S, d, mo, "spmm")
        out[name] = {
            "kernel": "spmm", "form": None, "m": mo, "n": Bd.shape[0],
            "r": d, "nnz": bound[5],
            "max_abs_err": ck.close(kern(), plain(), 2e-3,
                                    f"train_lm moe {name} kernel vs plain"),
            "ms": time_ms(torch, kern, reps),
            "plain_ms": time_ms(torch, plain, reps),
            "library_ms": time_ms(torch, lambda sp=sp, Bd=Bd:
                                  torch.sparse.mm(sp, Bd), reps),
            "bound_ms": bound[0], "bound_by": bound[1]}
        from repro_torch.kernels.spmm import spmm_cuda
        out[name]["form"] = spmm_cuda.last_form
    from repro_torch.kernels.sddmm import sddmm_cuda

    def kern_g():
        return ops.sddmm(A, y, DT, r_tile=d, blocks_per_step=1).vals

    def plain_g():
        return ops.sddmm(A, y, DT, backend="ref").vals
    pat = csr_of(DT, m)
    pvals = pat.values()
    yt = y.t()
    bound = _bound(torch, DT, d, None, "sddmm")
    out["dgate"] = {
        "kernel": "sddmm", "m": DT.shape[0], "n": m, "r": d,
        "nnz": bound[5],
        "max_abs_err": ck.close(kern_g(), plain_g(), 2e-5,
                                "train_lm moe dgate kernel vs plain"),
        "form": sddmm_cuda.last_form,
        "ms": time_ms(torch, kern_g, reps),
        "plain_ms": time_ms(torch, plain_g, reps),
        "library_ms": time_ms(torch, lambda: torch.sparse.sampled_addmm(
            pat, A, yt, beta=0.0).values() * pvals, reps),
        "bound_ms": bound[0], "bound_by": bound[1]}
    return out


def train_lm_moe(torch, ck, reps):
    """(B) one DeepSeek-V2-Lite MoE layer at full width, LM_MOE_TOKENS
    tokens: forward and backward under dispatch="spmm" (the Hopper SpMM
    and SDDMM under the dispatch's autograd Functions) against
    "einsum", every gradient leaf; the launches and forms of one counted
    backward; both passes' ms; the backward's kernels at their shapes.
    Returns (report, launches)."""
    from repro_torch.config import ParallelConfig
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cut, _ = deepseek_cut()
    pcfg = ParallelConfig(compute_dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(7)
    layer = MOE.MoE(L.Init(g, torch.float32, "cuda"), cut)
    B, S = LM_MOE_TOKENS
    x = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    proj = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    leaves = dict(layer.named_parameters())

    def step(dispatch):
        for p in leaves.values():
            p.grad = None
        xx = x.clone().requires_grad_(True)
        out, aux = MOE.moe(cut, pcfg, layer, xx, dispatch=dispatch)
        loss = (out * proj).sum() + TRAIN_LM_AUX * aux["lb_loss"]
        loss.backward()
        return xx

    xg = step("einsum")
    want = {"x": xg.grad, **{k: p.grad for k, p in leaves.items()}}
    ops.reset_launch_counts()
    xg = step("spmm")
    torch.cuda.synchronize()
    launches, forms = ops.launch_counts(), ops.form_counts()
    got = {"x": xg.grad, **{k: p.grad for k, p in leaves.items()}}
    if launches["spmm"] != 4 or forms["spmm"].get("bulk", 0) != 4 or \
            launches["sddmm"] != 1 or launches["fusedmm"] != 0:
        raise AssertionError(f"train_lm moe: expected 4 bulk SpMM and 1 "
                             f"SDDMM launches, got {launches} {forms}")
    errs = _leaf_check(ck, got, want, TRAIN_LM_MOE_TOL,
                       "train_lm moe spmm vs einsum grad")
    report = {"tokens": B * S, "experts": cut.moe_experts,
              "top_k": cut.moe_top_k,
              "capacity": int(cut.capacity_factor * B * S * cut.moe_top_k
                              / cut.moe_experts),
              "launches": launches, "forms": forms, "leaf_err": errs,
              "spmm_ms": time_ms(torch, lambda: step("spmm"), reps),
              "einsum_ms": time_ms(torch, lambda: step("einsum"), reps),
              "backward": train_lm_moe_kernels(torch, ck, cut, layer, x,
                                               proj, reps)}
    for p in leaves.values():
        p.grad = None
    del layer, leaves, got, want, xg
    torch.cuda.empty_cache()
    return report, launches


TRAIN_LM_TP_SHARES = 4      # (D) the expert-parallel shares on one card


def train_lm_tp_shares(torch, ck, reps):
    """(D) one DeepSeek-V2-Lite MoE layer at full width, LM_MOE_TOKENS
    tokens, as TRAIN_LM_TP_SHARES expert-parallel shares run in turn on
    one card (``moe.moe_share``, each E / shares experts on its slots,
    dispatch="spmm"; what each card of a model axis of that size runs):
    forward and backward of the shares' sum against the whole layer,
    every gradient leaf within 1e-3; the launches of one counted pass
    (4 bulk SpMM and 1 SDDMM a share); each share's three backward
    launches against their plain versions.  Returns (report,
    launches)."""
    import types
    from repro_torch.config import ParallelConfig
    from repro_torch.distributed.tensor_parallel import ONE
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cut, _ = deepseek_cut()
    pcfg = ParallelConfig(compute_dtype="float32")
    n = TRAIN_LM_TP_SHARES
    g = torch.Generator(device="cuda").manual_seed(7)
    layer = MOE.MoE(L.Init(g, torch.float32, "cuda"), cut)
    B, S = LM_MOE_TOKENS
    x = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    proj = torch.randn((B, S, cut.d_model), generator=g, device="cuda")
    leaves = dict(layer.named_parameters())
    per = cut.moe_experts // n

    def grads(loss, xx):
        loss.backward()
        return {"x": xx.grad, **{k: p.grad for k, p in leaves.items()}}

    def whole():
        for p in leaves.values():
            p.grad = None
        xx = x.clone().requires_grad_(True)
        out, aux = MOE.moe(cut, pcfg, layer, xx, dispatch="spmm")
        return grads((out * proj).sum() + TRAIN_LM_AUX * aux["lb_loss"], xx)

    def shares():
        for p in leaves.values():
            p.grad = None
        xx = x.clone().requires_grad_(True)
        xf = xx.reshape(B * S, cut.d_model)
        probs, _, gate_v, slot, keep, C, counts = MOE.route(cut, layer, xf)
        out = MOE._shared(layer, xf, ONE)
        for r in range(n):
            share = types.SimpleNamespace(**{
                k: getattr(layer, k)[r * per:(r + 1) * per]
                for k in ("w1", "w3", "w2")})
            out = out + MOE.moe_share(cut, share, xf, gate_v, slot, keep, C,
                                      r, n, "spmm")
        aux = MOE._aux(cut, probs, counts, None)["lb_loss"]
        return grads((out.reshape(B, S, -1) * proj).sum()
                     + TRAIN_LM_AUX * aux, xx)

    want = whole()
    want = {k: v.clone() for k, v in want.items()}
    ops.reset_launch_counts()
    got = shares()
    torch.cuda.synchronize()
    launches, forms = ops.launch_counts(), ops.form_counts()
    if launches["spmm"] != 4 * n or forms["spmm"].get("bulk", 0) != 4 * n \
            or launches["sddmm"] != n or launches["fusedmm"] != 0:
        raise AssertionError(f"train_lm (D): expected {4 * n} bulk SpMM and "
                             f"{n} SDDMM launches, got {launches} {forms}")
    errs = _leaf_check(ck, got, want, TRAIN_LM_MOE_TOL,
                       "train_lm (D) shares vs whole layer grad")
    report = {"shares": n, "experts_a_share": per, "tokens": B * S,
              "launches": launches, "forms": forms, "leaf_err": errs,
              "shares_ms": time_ms(torch, shares, reps),
              "whole_ms": time_ms(torch, whole, reps),
              "kernels": [train_lm_moe_kernels(torch, ck, cut, layer, x,
                                               proj, reps, r, n)
                          for r in range(n)]}
    for p in leaves.values():
        p.grad = None
    del layer, leaves, got, want
    torch.cuda.empty_cache()
    return report, launches


def train_lm_reduced(torch, ck):
    """(C) every reduced config: one train step on the card against the
    same weights and batch on the CPU: the loss, and every gradient the
    optimizer is given."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.launch.train import SMOKE_MODULES, resolve_config
    from repro_torch.models import model as M
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    pcfg = ParallelConfig(compute_dtype="float32")
    tcfg = TrainConfig(seq_len=32, global_batch=2, lr=1e-3, steps=10)
    out = {}
    for arch in SMOKE_MODULES:
        cfg = resolve_config(arch, True)
        g = torch.Generator(device="cuda").manual_seed(3)
        model = M.init_params(cfg, g, device="cuda")
        cpu = cpu_copy(torch, cfg, model)
        b = D.SyntheticLM(cfg.vocab, 32, 2, seed=2).batch(0)
        if not cfg.embed_inputs:
            eb = D.embeds_batch(0, 2, 32, cfg.d_model,
                                pos3=(cfg.pos_dims == 3))
            b = dict(eb, labels=b["labels"])
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        res = {}
        for where, mdl in (("cuda", model), ("cpu", cpu)):
            seen = []

            def spy(orig, seen=seen):
                def update(cfg_, params, grads, state):
                    seen.append({k: v.detach().cpu().clone()
                                 for k, v in grads.items()})
                    return orig(cfg_, params, grads, state)
                return update
            step, _, _ = ts.make_train_step(cfg, pcfg, tcfg, None)
            with patched(opt, "adamw_update", spy):
                m = step(mdl, opt.init_opt_state(mdl),
                         {k: v.to(where) for k, v in b.items()})
            res[where] = ({k: float(v) for k, v in m.items()}, seen[0])
        (mc, gc), (mp, gp) = res["cuda"], res["cpu"]
        if abs(mc["loss"] - mp["loss"]) > TRAIN_LM_CPU_TOL * max(
                1.0, abs(mp["loss"])):
            raise AssertionError(f"train_lm (C) {arch}: loss {mc['loss']} "
                                 f"vs CPU {mp['loss']}")
        ck.n += 1
        errs = _leaf_check(ck, gc, gp, TRAIN_LM_CPU_TOL,
                           f"train_lm (C) {arch} grad")
        out[arch] = {"loss": mc["loss"], "cpu_loss": mp["loss"],
                     "grad_norm": mc["grad_norm"],
                     "max_leaf_err": max(errs.values())}
        del model, cpu
    torch.cuda.empty_cache()
    return out


def phase_train_lm(torch, reps: int):
    """The LM zoo's training path on the card: (C) every reduced config
    against the CPU, (A) llama3.2-1b at full width and depth through
    launch.train.main, (A2) exact resume at full width (depth cut), (B)
    the MoE SpMM dispatch's backward at DeepSeek-V2-Lite's width, (D)
    that layer's expert-parallel shares in turn, (E) remat against none
    bit for bit.  Returns the launches of (B)'s and of (D)'s counted
    forward and backward."""
    ck = Checker(torch)
    t0 = time.perf_counter()
    report = {"phase": "train_lm", "device": torch.cuda.get_device_name(0),
              "reduced": train_lm_reduced(torch, ck)}
    report["seconds_reduced"] = time.perf_counter() - t0
    report["llama"] = train_lm_full(torch, ck)
    report["seconds_llama"] = time.perf_counter() - t0
    report["resume"] = train_lm_resume(torch, ck)
    report["seconds_resume"] = time.perf_counter() - t0
    report["moe"], launches = train_lm_moe(torch, ck, reps)
    report["seconds_moe"] = time.perf_counter() - t0
    report["tp_shares"], tp_launches = train_lm_tp_shares(torch, ck, reps)
    report["seconds_tp_shares"] = time.perf_counter() - t0
    report["remat"] = train_lm_remat(torch, ck)
    report.update(launches=launches, tp_launches=tp_launches, checks=ck.n,
                  seconds=time.perf_counter() - t0)
    emit(report)
    return launches, tp_launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rmat-scale", type=int, default=21)
    ap.add_argument("--families-scale", type=int, default=22)
    ap.add_argument("--apps-scale", type=int, default=20)
    ap.add_argument("--comm-scale", type=int, default=22)
    ap.add_argument("--dist-serving-only", action="store_true",
                    help="the dist phase runs its serving cells alone")
    ap.add_argument("--dist-train-only", action="store_true",
                    help="the dist phase runs its train cells alone")
    ap.add_argument("--dist-tp-only", action="store_true",
                    help="the dist phase runs its tensor-parallel cells "
                         "alone (four cards)")
    ap.add_argument("--dist-tp-sums-only", action="store_true",
                    help="the dist phase times the model group's sum in "
                         "its two forms alone (four cards)")
    ap.add_argument("--dist-fsdp-only", action="store_true",
                    help="the dist phase runs its FSDP cells alone (four "
                         "cards)")
    ap.add_argument("--dist-serve-tp-only", action="store_true",
                    help="the dist phase runs its serving cells on the "
                         "model axis alone (four cards)")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    from repro_torch.kernels import _build  # noqa: F401  (the port is here)
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    kernels, family_launches, dist_launches = None, None, None
    train_launches, sparse_launches, fault_launches = None, None, None
    serving_launches, obs_launches, dist_serving_launches = None, None, None
    lm_launches, train_lm_launches = None, None
    train_lm_tp_launches, dist_tp_launches = None, None
    dist_fsdp_launches, serve_tp_rows = None, None
    main_state = {} if "obs" in phases else None
    for ph in phases:
        t0 = time.perf_counter()
        if ph == "build":
            phase_build()
        elif ph == "kernels":
            phase_kernels(torch)
        elif ph == "main":
            kernels = phase_main(torch, args.scale, args.reps,
                                 args.rmat_scale, keep=main_state)
        elif ph == "obs":
            obs_launches = phase_obs(torch, args.scale, args.reps,
                                     main_state or None)
            main_state = None
        elif ph == "families":
            family_launches = phase_families(torch, args.families_scale,
                                             args.reps, args.scale)
        elif ph == "comm_sparse":
            sparse_launches = phase_comm_sparse(torch, args.comm_scale,
                                                args.reps)
        elif ph == "stacked":
            phase_stacked(torch)
        elif ph == "faults":
            fault_launches = phase_faults(torch, args.scale,
                                          args.apps_scale)
        elif ph == "serving":
            serving_launches = phase_serving(torch, args.scale,
                                             args.apps_scale)
        elif ph == "dist":
            (dist_launches, dist_serving_launches, dist_tp_launches,
             dist_fsdp_launches, serve_tp_rows) = phase_dist(
                torch, args.scale, args.reps, args.comm_scale,
                args.apps_scale,
                "serving" if args.dist_serving_only
                else "train" if args.dist_train_only
                else "tp" if args.dist_tp_only
                else "tp_sums" if args.dist_tp_sums_only
                else "fsdp" if args.dist_fsdp_only
                else "serve_tp" if args.dist_serve_tp_only
                else None)
        elif ph == "rmat_padding":
            phase_rmat_padding(torch, args.comm_scale - 2)
        elif ph == "train":
            train_launches = phase_train(torch, args.scale, args.apps_scale,
                                         args.reps)
        elif ph == "lm":
            lm_launches = phase_lm(torch, args.reps)
        elif ph == "train_lm":
            train_lm_launches, train_lm_tp_launches = phase_train_lm(
                torch, args.reps)
        else:
            raise SystemExit(f"unknown phase {ph!r}")
        log(f"phase {ph}: {time.perf_counter() - t0:.1f} s")
    if kernels is not None:
        for row in kernels:
            row["families_launches"] = (None if family_launches is None
                                        else family_launches[row["name"]])
            row["comm_sparse_launches"] = (None if sparse_launches is None
                                           else sparse_launches[row["name"]])
            row["dist_launches"] = (None if dist_launches is None
                                    else dist_launches[row["name"]])
            row["train_launches"] = (None if train_launches is None
                                     else train_launches[row["name"]])
            row["faults_launches"] = (None if fault_launches is None
                                      else fault_launches[row["name"]])
            row["serving_launches"] = (None if serving_launches is None
                                       else serving_launches[row["name"]])
            row["dist_serving_launches"] = (
                None if dist_serving_launches is None
                else [{cell: c[row["name"]] for cell, c in rk.items()}
                      for rk in dist_serving_launches])
            row["obs_launches"] = (None if obs_launches is None
                                   else obs_launches[row["name"]])
            row["lm_launches"] = (None if lm_launches is None
                                  else lm_launches[row["name"]])
            row["train_lm_launches"] = (
                None if train_lm_launches is None
                else train_lm_launches[row["name"]])
            row["train_lm_tp_launches"] = (
                None if train_lm_tp_launches is None
                else train_lm_tp_launches[row["name"]])
            row["dist_tp_launches"] = (
                None if dist_tp_launches is None
                else [rk[row["name"]] for rk in dist_tp_launches])
            row["dist_fsdp_launches"] = (
                None if dist_fsdp_launches is None
                else [rk[row["name"]] for rk in dist_fsdp_launches])
        emit({"kernels": kernels})
    elif serve_tp_rows is not None:
        emit({"kernels": serve_tp_rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
