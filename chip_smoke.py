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
           check_faults.py's guarantee 3 at 2^--apps-scale: a 6-step
           train_embedding_distributed on 8 ranks losing rank 7 at the
           step-3 SDDMM == a fault-free run checkpointed at step 3 and
           resumed on the degraded grid (X, Y, losses of steps 3-5, bit
           for bit), the later checkpoint's meta on the new p;
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
           and timed).  A rank that fails, or any still running after
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

Then a ``{"kernels": [...]}`` line, each card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
Any failed check raises, and the script exits non-zero before the last
line.  ``--scale`` shrinks the main path, the faults phase's (a)-(d),
the dist phase and sections A and B of the train phase (2^scale rows),
``--families-scale`` the families phase, ``--apps-scale`` section C and
the faults phase's (e), ``--rmat-scale`` the
power-law timing and ``--comm-scale`` the comm_sparse phase and the
dist phase's R-MAT cells for rehearsals;
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

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside tensor cores
PHASES = ("build", "kernels", "main", "families", "comm_sparse",
          "rmat_padding", "stacked", "faults", "dist", "train")

# tests/test_kernels.py shapes and tolerances
SHAPES = [(128, 128, 64, 4), (256, 128, 128, 8), (512, 384, 128, 8),
          (384, 512, 256, 2), (128, 640, 32, 16)]
TILINGS = [(128, 1), (64, 1), (32, 2), (32, 4)]
# (m, n, r, nonzeros per row, row_tile, nz_block, dtype name, the form the
# spmm and sddmm wrappers must choose, the fused kernel's route); the last
# two have windows of 8192 entries, 32 staged index chunks each
FORM_CASES = [(256, 192, 34, 6, 64, 32, "float32", "load", "two_pass"),
              (256, 192, 36, 6, 64, 32, "bfloat16", "load", "load"),
              (256, 192, 36, 6, 64, 32, "float32", "bulk", "bulk"),
              (512, 4096, 128, 64, 128, 64, "float32", "bulk", "bulk"),
              (512, 4096, 128, 64, 128, 64, "bfloat16", "bulk", "bulk")]


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
        if (sddmm_cuda.last_form, spmm_cuda.last_form) != (form, form):
            raise AssertionError(f"{tag}: forms {sddmm_cuda.last_form}/"
                                 f"{spmm_cuda.last_form}, want {form}")
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
        forms.append(f"{form}/{fused}: {tag}")
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


def phase_main(torch, scale: int, reps: int, rmat_scale: int):
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
    plan = prob.plan("normal")
    S = sparse.RowTiledCOO(plan.rows_local[0][0, 0], plan.cols[0][0, 0],
                           plan.vals[0][0, 0], plan.tile_base[0][0, 0],
                           plan.block_shape, plan.row_tile)
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

            def timing(orig):
                def spy(*a, **k):
                    t0 = time.perf_counter()
                    out = orig(*a, **k)
                    sup_s.append(time.perf_counter() - t0)
                    return out
                return spy

            t0 = time.perf_counter()
            with patched(mod, "_sparse_sup", timing):
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

    def timing(orig):
        def spy(*a, **k):
            t1 = time.perf_counter()
            out = orig(*a, **k)
            degrade_s.append(time.perf_counter() - t1)
            return out
        return spy

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
    with faults.inject(plan) as ctl, patched(api, "degrade", timing):
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
    # (gat.graph_coo's construction, drawn on the card)
    packs, marks = [], []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows, cols, _ = erdos_renyi_on_card(torch, m, m, per_row, 0)
    loops = torch.arange(m, device="cuda")
    key = torch.unique(torch.cat([
        torch.from_numpy(rows.astype(np.int64)).cuda() * m
        + torch.from_numpy(cols).cuda(), loops * m + loops]))
    gp = api.make_problem((key // m).int().cpu().numpy(),
                          (key % m).int().cpu().numpy(),
                          np.ones(key.numel(), np.float32), (m, m), r)
    del rows, cols, key, loops
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
    """The torch.distributed backend with CUDA events around each
    collective, in a serial pass: the ranks are lined up first (the card
    idle, then an all-reduce of one word), so a span holds the transfer
    and not a wait for a peer's kernel."""
    import torch.distributed as dist
    from repro_torch.core.collectives import Dist

    class Timed(Dist):
        def __init__(self, grid):
            super().__init__(grid)
            self.spans = []

        def _span(self, fn, *args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            dist.all_reduce(torch.zeros(1, device=self.grid.device),
                            group=self.grid.group)
            torch.cuda.synchronize()
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            ev = self.log[-1]
            crossed = self.grid.shape[self.grid.dim(ev.axis)] > 1
            self.spans.append((ev.kind, ev.words, crossed, e0, e1))
            return out

        def permute(self, *args, **kwargs):
            return self._span(super().permute, *args, **kwargs)

        def all_gather(self, *args, **kwargs):
            return self._span(super().all_gather, *args, **kwargs)

        def psum_scatter(self, *args, **kwargs):
            return self._span(super().psum_scatter, *args, **kwargs)

        def by_kind(self):
            """{kind: ms, bytes, moves, GB/s and share of NVLink's rate}
            over the collectives that crossed a rank (4-byte words)."""
            torch.cuda.synchronize()
            out = {}
            for kind, words, crossed, e0, e1 in self.spans:
                if not crossed:
                    continue
                k = out.setdefault(kind, {"ms": 0.0, "bytes": 0.0,
                                          "moves": 0})
                k["ms"] += e0.elapsed_time(e1)
                k["bytes"] += 4 * words
                k["moves"] += 1
            for k in out.values():
                k["gb_per_s"] = k["bytes"] / k["ms"] / 1e6 if k["ms"] else None
                k["nvlink_share"] = (k["gb_per_s"] / NVLINK_GB_PER_S
                                     if k["gb_per_s"] else None)
            return out

    return Timed


def dist_rank(rank: int, world: int, init: str, scale: int, reps: int,
              comm_scale: int, out_dir: str) -> None:
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
                            comm_scale)
    finally:
        dist.destroy_process_group()
    with open(pathlib.Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(report, f)


def _leaves(res):
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _leaves(r)]
    return [res]


def _dist_rank(torch, dist, rank, world, scale, reps, comm_scale):
    from repro_torch.core import api, costmodel
    from repro_torch.kernels import ops
    ck = Checker(torch)
    dev = torch.device("cuda", rank)
    m = n = 1 << scale
    r, per_row, seed = 128, 16, 0
    rows, cols, vals = erdos_renyi_on_card(torch, m, n, per_row, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    X = torch.randn((m, r), generator=g, device="cuda")
    Y = torch.randn((n, r), generator=g, device="cuda")
    Timed = _timed_backend(torch)
    report = {"rank": rank, "world": world, "m": m, "r": r,
              "nnz": int(len(vals)), "problems": {}}
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
            cell["comm"] = coll.by_kind()
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
    report["checks"] = ck.n
    return report


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
            by_kind = coll.by_kind()
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

    def timing(orig):
        def spy(*a, **k):
            t1 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                degrade_s.append(time.perf_counter() - t1)
        return spy

    plan = faults.FaultPlan.scripted(faults.FaultSpec(
        op="fusedmm", rank=DIST_FAULT_LOST, round=0, kind="device_lost"))
    ep = api.ElasticProblem(prob)
    t0 = time.perf_counter()
    try:
        with faults.inject(plan), patched(api, "degrade", timing):
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


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist(torch, scale: int, reps: int, comm_scale: int):
    """One process per visible card over NCCL (``dist_rank``); fails if
    a rank fails or any outlives DIST_TIMEOUT_S (all are stopped)."""
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
                                                     out_dir))
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
    if world > 1:
        # the survivors recovered onto the degraded group, every other
        # rank (the lost one among them) retired
        outs = [rr["faults"]["outcome"] for rr in ranks]
        p_after = ranks[0]["faults"]["p_after"]
        if outs != ["recovered"] * p_after + ["retired"] * (world - p_after) \
                or outs[DIST_FAULT_LOST] != "retired":
            raise AssertionError(f"dist faults: outcomes {outs}")
    emit(report)
    return ranks[0]["problems"]["d15"]["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rmat-scale", type=int, default=21)
    ap.add_argument("--families-scale", type=int, default=22)
    ap.add_argument("--apps-scale", type=int, default=20)
    ap.add_argument("--comm-scale", type=int, default=22)
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
    for ph in phases:
        t0 = time.perf_counter()
        if ph == "build":
            phase_build()
        elif ph == "kernels":
            phase_kernels(torch)
        elif ph == "main":
            kernels = phase_main(torch, args.scale, args.reps,
                                 args.rmat_scale)
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
        elif ph == "dist":
            dist_launches = phase_dist(torch, args.scale, args.reps,
                                       args.comm_scale)
        elif ph == "rmat_padding":
            phase_rmat_padding(torch, args.comm_scale - 2)
        elif ph == "train":
            train_launches = phase_train(torch, args.scale, args.apps_scale,
                                         args.reps)
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
        emit({"kernels": kernels})
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
