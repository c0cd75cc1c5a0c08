"""Alpha-beta-gamma communication model + local-kernel tiling model.

A copy of ``repro.core.costmodel`` (numpy only): the paper's Table III
(latency/bandwidth costs per algorithm, embedded in the FusedMM
procedure) and Table IV (optimal replication factors), the regime
selection rule of §V-E, and the tiling model.  The tiling model keeps
the reference's numbers so that the port's plans equal the reference's;
the CUDA kernels accept ``r_tile``/``blocks_per_step`` for parity (the
fused kernel switches to its two-pass form when ``r_tile < r``), and a
model of Hopper's shared memory is later work.

All word counts are *per processor* (the max over processors, assuming
the random-permutation load balancing of §VI).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np

ALGORITHMS = (
    "d15_no_elision",        # 1.5D dense shift, unoptimized SDDMM;SpMM
    "d15_replication_reuse", # 1.5D dense shift + replication reuse
    "d15_local_fusion",      # 1.5D dense shift + local kernel fusion
    "s15_no_elision",        # 1.5D sparse shift, unoptimized baseline
    "s15_replication_reuse", # 1.5D sparse shift + replication reuse
    "s15_local_fusion",      # 1.5D sparse shift + one-structure-pass
    "d25_no_elision",        # 2.5D dense replicating, unoptimized
    "d25_replication_reuse", # 2.5D dense replicating + replication reuse
    "d25_local_fusion",      # 2.5D dense replicating + one-structure-pass
    "s25_no_elision",        # 2.5D sparse replicating, unoptimized
    "s25_replication_reuse", # 2.5D sparse replicating + B-chunk reuse
)

# Table-III algorithm name -> (executor family, elision strategy).  The
# families are the four implementations behind repro.core.api; elision is
# the FusedMM strategy the family executor takes as its static argument.
# The grid is full rank: every (family, elision) cell a registry entry
# declares has exactly one word-count row here (docs/algorithms.md
# derives the formulas; rows beyond the paper's Table III price the
# one-structure-pass "fused" cells and s25's B-chunk "reuse").  The one
# structurally impossible cell — s25 "fused" — has no row because no
# executor can exist for it (see docs/algorithms.md).
FAMILY_ELISION = {
    "d15_no_elision": ("d15", "none"),
    "d15_replication_reuse": ("d15", "reuse"),
    "d15_local_fusion": ("d15", "fused"),
    "s15_no_elision": ("s15", "none"),
    "s15_replication_reuse": ("s15", "reuse"),
    "s15_local_fusion": ("s15", "fused"),
    "d25_no_elision": ("d25", "none"),
    "d25_replication_reuse": ("d25", "reuse"),
    "d25_local_fusion": ("d25", "fused"),
    "s25_no_elision": ("s25", "none"),
    "s25_replication_reuse": ("s25", "reuse"),
}

# inverse of FAMILY_ELISION: (family, elision) -> Table-III row name.
# Sound because the grid is full rank with exactly one row per cell.
ELISION_COST_NAME = {fe: name for name, fe in FAMILY_ELISION.items()}

FAMILIES = ("d15", "s15", "d25", "s25")


@dataclasses.dataclass(frozen=True)
class CommCost:
    algorithm: str
    p: int
    c: int
    words: float      # words sent+received per processor (beta term)
    messages: float   # message count (alpha term)
    phi: float

    def time(self, alpha: float, beta: float) -> float:
        return self.alpha_time(alpha) + self.beta_time(beta)

    def alpha_time(self, alpha: float) -> float:
        return alpha * self.messages

    def beta_time(self, beta: float) -> float:
        return beta * self.words


def _check(p: int, c: int):
    if c < 1 or p % c:
        raise ValueError(f"replication factor c={c} must divide p={p}")


def words_fusedmm(algorithm: str, *, p: int, c: int, n: int, r: int,
                  nnz: int) -> CommCost:
    """Words communicated per processor for a FusedMM call (Table III)."""
    _check(p, c)
    phi = nnz / (n * r)
    if algorithm == "d15_no_elision":
        words = n * r * (2.0 / c + 2.0 * (c - 1) / p)
        msgs = 2 * p / c + 2 * (c - 1)
    elif algorithm == "d15_replication_reuse":
        words = n * r * (2.0 / c + (c - 1) / p)
        msgs = 2 * p / c + (c - 1)
    elif algorithm == "d15_local_fusion":
        words = n * r * (1.0 / c + 2.0 * (c - 1) / p)
        msgs = p / c + 2 * (c - 1)
    elif algorithm == "s15_no_elision":
        # two full COO propagation rounds (3 words/nnz each) and the
        # dense column slices re-gathered between the kernel launches
        words = n * r * (6.0 * phi / c + 2.0 * (c - 1) / p)
        msgs = 2 * p / c + 2 * (c - 1)
    elif algorithm == "s15_replication_reuse":
        words = n * r * (6.0 * phi / c + (c - 1) / p)
        msgs = 2 * p / c + (c - 1)
    elif algorithm == "s15_local_fusion":
        # one-structure-pass: the SpMM round replays the locally cached
        # per-phase coordinate structure, so only the final values travel
        # (1 word/nnz/phase instead of 3): 6*phi -> 4*phi
        words = n * r * (4.0 * phi / c + (c - 1) / p)
        msgs = 2 * p / c + (c - 1)
    elif algorithm == "d25_no_elision":
        sq = math.sqrt(p / c)
        words = n * r / math.sqrt(p * c) * (6 * phi + 2) \
            + 2 * n * r * (c - 1) / p
        msgs = 4 * sq + 2 * (c - 1)
    elif algorithm == "d25_replication_reuse":
        sq = math.sqrt(p / c)
        words = n * r / math.sqrt(p * c) * (6 * phi + 2) \
            + n * r * (c - 1) / p
        msgs = 4 * sq + (c - 1)
    elif algorithm == "d25_local_fusion":
        # one-structure-pass on the Cannon grid: round 2 replays cached
        # structure AND cached B chunks, shifting only the final values —
        # 6*phi+2 -> 4*phi+1 on the shift term; AG in + RS out retained
        sq = math.sqrt(p / c)
        words = n * r / math.sqrt(p * c) * (4 * phi + 1) \
            + 2 * n * r * (c - 1) / p
        msgs = 4 * sq + 2 * (c - 1)
    elif algorithm == "s25_no_elision":
        sq = math.sqrt(p / c)
        words = n * r / math.sqrt(p) * 4.0 / math.sqrt(c) \
            + 3.0 * phi * n * r * (c - 1) / p
        msgs = 4 * sq + 3 * (c - 1)
    elif algorithm == "s25_replication_reuse":
        # the SpMM round replays the B r-chunks cached during the SDDMM
        # round instead of re-shifting them: 4 -> 3 dense-chunk units
        sq = math.sqrt(p / c)
        words = n * r / math.sqrt(p * c) * 3.0 \
            + 3.0 * phi * n * r * (c - 1) / p
        msgs = 3 * sq + 3 * (c - 1)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return CommCost(algorithm, p, c, words, msgs, phi)


# Fraction of a cell's replication term an api.Session elides in steady
# state.  The Session caches the fiber all-gather of the *stationary*
# (second, by convention) dense operand across calls.  Cells whose
# gathered operand is the changing first one (d15/d25 "none"/"fused")
# save nothing; the FusedMMB "reuse" cells gather exactly the stationary
# operand (full saving); s15 gathers both operands through the Session,
# so only the stationary half of its replication term is cacheable; s25
# replicates nothing dense.  See docs/choosing.md for the derivation.
SESSION_CACHEABLE = {
    "d15_replication_reuse": 1.0,
    "d25_replication_reuse": 1.0,
    "s15_no_elision": 0.5,
    "s15_replication_reuse": 0.5,
    "s15_local_fusion": 0.5,
}


def words_fusedmm_cached(algorithm: str, *, p: int, c: int, n: int, r: int,
                         nnz: int) -> CommCost:
    """Steady-state per-call words with an :class:`repro.core.api.Session`
    holding the stationary operand's replication (docs/choosing.md).

    Subtracts the cacheable share of the cell's ``n*r*(c-1)/p``
    replication term from :func:`words_fusedmm`; the shift words are
    never cacheable (the traveling operand changes every call).
    """
    cost = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz)
    frac = SESSION_CACHEABLE.get(algorithm, 0.0)
    saved = frac * n * r * (c - 1) / p
    return dataclasses.replace(cost, words=max(cost.words - saved, 0.0),
                               messages=max(cost.messages - frac * (c - 1),
                                            0.0))


def words_spmm(family: str, *, p: int, c: int, n: int, r: int,
               nnz: int) -> CommCost:
    """Words per processor for ONE distributed SpMM (or SpMM^T) round.

    Table III embeds two kernel rounds in every FusedMM row; these are
    the single-round costs, needed to price the backward pass — each
    transpose-SpMM of a VJP is one such round on the same grid.  By the
    paper's SpMM<->SDDMM duality the transpose orientation ships the
    same words (the traveling/replicated roles are symmetric).
    """
    _check(p, c)
    phi = nnz / (n * r)
    if family == "d15":
        words = n * r * (1.0 / c + (c - 1) / p)
        msgs = p / c + (c - 1)
    elif family == "s15":
        words = n * r * (3.0 * phi / c + (c - 1) / p)
        msgs = p / c + (c - 1)
    elif family == "d25":
        sq = math.sqrt(p / c)
        words = n * r * (3 * phi + 1) / math.sqrt(p * c) \
            + n * r * (c - 1) / p
        msgs = 2 * sq + (c - 1)
    elif family == "s25":
        sq = math.sqrt(p / c)
        words = n * r * 2.0 / math.sqrt(p * c) \
            + phi * n * r * (c - 1) / p
        msgs = 2 * sq + (c - 1)
    else:
        raise ValueError(f"unknown family {family!r}")
    return CommCost(f"{family}_spmm", p, c, words, msgs, phi)


# ---------------------------------------------------------------------------
# Sparsity-aware communication (comm="sparse") — nnz-dependent words
# ---------------------------------------------------------------------------
#
# Support pruning ships only the rows of a dense input operand that the
# receiver's nonzeros read (SpComm3D's observation, PAPERS.md).  The
# pruned channels per family are exactly the implementation's
# (docs/algorithms.md "Sparse communication"):
#
#   d15: fiber AG of the replicated operand; traveling B input chunks
#        (both FusedMM rounds where B travels — never the traveling
#        FusedMMB/SpMMB *output* accumulator, whose FP order is exact)
#   s15: both fiber all-gathers of the dense column slabs (the COO pack
#        shifts are already 3 words/nnz — nothing dense travels)
#   d25: fiber AG of A; traveling B input chunks on the Cannon rows
#   s25: traveling A and B input r-chunks (nothing dense is replicated;
#        fiber traffic is values-only and stays exact)
#
# Reduce-scatters and traveling accumulators always stay dense.  The
# formulas below take the measured support densities rho_row/rho_col
# (fraction of rows/cols of S with at least one nonzero) and price each
# pruned channel at rho x its dense words; they are per-processor and
# channel-exact against the implementation up to padding (per-offset
# supports pad to the max over devices) and locality (per-device block
# supports are smaller than the global rho), so measured wire words land
# slightly *below* these estimates on skewed matrices.

SPARSE_CROSSOVER = 0.9
"""Per-channel fallback threshold: a channel ships pruned only when its
padded support words are below this fraction of its dense words —
otherwise index+pad overhead makes pruning a loss and the planner keeps
the dense schedule for that channel (recorded in the plan's SparseMeta)."""


def support_density(rows, cols, m: int, n: int):
    """(rho_row, rho_col): fraction of rows/cols of S that are nonempty.

    The cheap host-side statistic ``comm="auto"`` decides from — an upper
    bound on every per-device support density (a device's support is the
    union over only *its* blocks' nonzeros).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    rho_r = (np.unique(rows).size / m) if m else 1.0
    rho_c = (np.unique(cols).size / n) if n else 1.0
    return float(rho_r), float(rho_c)


def choose_comm(rows, cols, m: int, n: int) -> str:
    """The ``comm="auto"`` rule: prune when *either* support is sparse.

    One sparse side is enough — each channel falls back to dense
    independently (SPARSE_CROSSOVER), so a matrix with full column
    support but skewed row support still wins on its gather channels.
    See docs/choosing.md.
    """
    rho_r, rho_c = support_density(rows, cols, m, n)
    return "sparse" if min(rho_r, rho_c) <= SPARSE_CROSSOVER else "dense"


def words_fusedmm_sparse(algorithm: str, *, p: int, c: int, m: int, n: int,
                         r: int, nnz: int, rho_row: float,
                         rho_col: float) -> CommCost:
    """Per-processor FusedMM words under comm="sparse" (channel-exact).

    Mirrors the implementation's channel inventory (module comment):
    dense-channel terms match :func:`words_fusedmm`'s Table-III rows at
    rho = 1; pruned channels scale by the support density of the axis
    that indexes them (the gathered operand by ``rho_row`` of S — its
    rows index the replicated matrix — and the traveling B chunks by
    ``rho_col``).  ``m``/``n`` are S's dims (the existing dense model
    assumes square; this one does not need to).
    """
    _check(p, c)
    phi = nnz / (n * r)
    L = p // c
    G = int(math.isqrt(p // c)) if p // c else 1
    ra, rb = rho_row, rho_col
    if algorithm.startswith("d15"):
        ag = (c - 1) * (m // p) * r          # one dense AG/RS unit
        rnd = max(L - 1, 0) * (n // p) * r   # one dense-B trip round
        out = L * (n // p) * r               # FusedMMB output trips
        words = {"d15_no_elision": ag * (1 + ra) + 2 * rnd * rb,
                 "d15_replication_reuse": ag * ra + rnd * rb + out,
                 "d15_local_fusion": ag * (1 + ra) + rnd * rb,
                 }[algorithm]
        msgs = 2 * (c - 1) + {"d15_no_elision": 2 * max(L - 1, 0),
                              "d15_replication_reuse": max(L - 1, 0) + L,
                              "d15_local_fusion": max(L - 1, 0)}[algorithm]
    elif algorithm.startswith("s15"):
        gth_a = (c - 1) * m * (r // p)       # one dense column-slab AG
        gth_b = (c - 1) * n * (r // p)
        shift = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz).words \
            - n * r * (2 if algorithm == "s15_no_elision" else 1) * (c - 1) / p
        n_gb = 2 if algorithm == "s15_no_elision" else 1
        words = shift + gth_a * ra + n_gb * gth_b * rb
        msgs = (1 + n_gb) * (c - 1) + 2 * p / c
    elif algorithm.startswith("d25"):
        mA, nS, rW = m // (G * c), n // (G * c), r // G
        ag = (c - 1) * mA * rW               # AG unit (RS same, dense)
        rnd = max(G - 1, 0) * nS * rW        # one dense-B trip round
        out = G * nS * rW
        coo = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz).words
        # strip the dense model's AG/RS and dense-chunk terms, keep COO
        dense_units = {"d25_no_elision": (2, 2), "d25_local_fusion": (2, 1),
                       "d25_replication_reuse": (1, 1)}[algorithm]
        coo -= dense_units[0] * n * r * (c - 1) / p
        coo -= (dense_units[1] * G * nS * rW
                if algorithm != "d25_replication_reuse" else G * nS * rW)
        coo = max(coo, 0.0)
        words = {"d25_no_elision": ag * (1 + ra) + 2 * rnd * rb,
                 "d25_replication_reuse": ag * ra + rnd * rb + out,
                 "d25_local_fusion": ag * (1 + ra) + rnd * rb,
                 }[algorithm] + coo
        msgs = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz).messages
    elif algorithm.startswith("s25"):
        mS, nS, rc = m // G, n // G, r // (G * c)
        a_rnd = max(G - 1, 0) * mS * rc      # one A-chunk trip round
        b_rnd = max(G - 1, 0) * nS * rc
        out = G * mS * rc                    # output trips (dense)
        vals = 3.0 * phi * n * r * (c - 1) / p   # fiber values (dense)
        n_b = 2 if algorithm == "s25_no_elision" else 1
        words = a_rnd * ra + n_b * b_rnd * rb + out + vals
        msgs = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz).messages
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return CommCost(f"{algorithm}_sparse", p, c, float(words), float(msgs),
                    phi)


def words_spmm_sparse(family: str, *, p: int, c: int, m: int, n: int,
                      r: int, nnz: int, rho_row: float,
                      rho_col: float) -> CommCost:
    """Per-processor words of ONE SpMM round under comm="sparse"."""
    _check(p, c)
    phi = nnz / (n * r)
    L = p // c
    G = int(math.isqrt(p // c)) if p // c else 1
    dense = words_spmm(family, p=p, c=c, n=n, r=r, nnz=nnz)
    if family == "d15":      # B trip pruned; RS stays dense
        words = (c - 1) * (m // p) * r + max(L - 1, 0) * (n // p) * r \
            * rho_col
    elif family == "s15":    # one gather pruned; COO trip already sparse
        words = dense.words - n * r * (c - 1) / p \
            + rho_col * (c - 1) * n * (r // p)
    elif family == "d25":    # B trips pruned; RS dense; COO kept
        nS, rW = n // (G * c), r // G
        words = dense.words - G * nS * rW + max(G - 1, 0) * nS * rW * rho_col
    elif family == "s25":    # B trips pruned; output + values dense
        mS, nS, rc = m // G, n // G, r // (G * c)
        words = G * mS * rc + max(G - 1, 0) * nS * rc * rho_col \
            + phi * n * r * (c - 1) / p
    else:
        raise ValueError(f"unknown family {family!r}")
    return CommCost(f"{family}_spmm_sparse", p, c, float(words),
                    float(dense.messages), phi)


# Replication units (of n*r*(c-1)/p words) a Session elides from the
# BACKWARD pass when the same Session that served the forward is threaded
# through the VJP (repro.core.grads): the backward's dual FusedMM finds
# the stationary operand's fiber replication already resident (gathered
# by the forward), and the SpMM^T that gathers the forward's replicated
# operand X replays it too.  d15/d25/s15 each elide two gathers (one in
# the dual FusedMM, one in a transpose-SpMM); s25 replicates nothing
# dense, so a Session elides nothing there.  Distinct from
# SESSION_CACHEABLE, which models the *across-call* steady state used by
# elision="auto" ranking — this is the *within-step* fwd->bwd replay.
SESSION_BWD_ELIDED = {"d15": 2.0, "s15": 2.0, "d25": 2.0, "s25": 0.0}


def words_fusedmm_bwd(algorithm: str, *, p: int, c: int, n: int, r: int,
                      nnz: int, session: bool = False) -> CommCost:
    """Words per processor for the BACKWARD of one FusedMM call.

    The VJP (repro.core.grads) is built from dual primitives on the same
    pack and cell: grad-wrt-X is the SAME FusedMM cell with the output
    cotangent in X's slot (one Table-III row), and grad-wrt-Y is two
    transpose-SpMMs (R^T g and Ghat^T X) — so

        bwd = words_fusedmm(cell) + 2 * words_spmm(family)

    and forward and backward provably ship the same words per primitive.
    ``session=True`` credits the within-step replication replay
    (SESSION_BWD_ELIDED): the forward's fiber gathers are reused by the
    backward instead of re-communicated.
    """
    family, _ = FAMILY_ELISION[algorithm]
    fm = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz)
    sp = words_spmm(family, p=p, c=c, n=n, r=r, nnz=nnz)
    words = fm.words + 2 * sp.words
    msgs = fm.messages + 2 * sp.messages
    if session:
        units = SESSION_BWD_ELIDED[family]
        words = max(words - units * n * r * (c - 1) / p, 0.0)
        msgs = max(msgs - units * (c - 1), 0.0)
    return CommCost(f"{algorithm}_bwd", p, c, words, msgs, fm.phi)


def words_trainstep(algorithm: str, *, p: int, c: int, n: int, r: int,
                    nnz: int, session: bool = False) -> CommCost:
    """Words per processor for one training step: forward FusedMM plus
    its dual-primitive backward (words_fusedmm_bwd).  The forward always
    pays its full replication (it fills the Session); only the backward
    is credited the replay."""
    fwd = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz)
    bwd = words_fusedmm_bwd(algorithm, p=p, c=c, n=n, r=r, nnz=nnz,
                            session=session)
    return CommCost(f"{algorithm}_trainstep", p, c, fwd.words + bwd.words,
                    fwd.messages + bwd.messages, fwd.phi)


def optimal_c(algorithm: str, *, p: int, phi: float = 0.0) -> float:
    """Closed-form optimal replication factor (Table IV, continuous)."""
    if algorithm == "d15_no_elision":
        return math.sqrt(p)
    if algorithm == "d15_replication_reuse":
        return math.sqrt(2 * p)
    if algorithm == "d15_local_fusion":
        return math.sqrt(p / 2)
    if algorithm == "s15_no_elision":
        return math.sqrt(3 * p * phi)
    if algorithm == "s15_replication_reuse":
        return math.sqrt(6 * p * phi)
    if algorithm == "s15_local_fusion":
        return 2 * math.sqrt(p * phi)
    if algorithm == "d25_no_elision":
        return (p * (1 + 3 * phi) ** 2 / 4) ** (1 / 3)
    if algorithm == "d25_replication_reuse":
        return (p * (1 + 3 * phi) ** 2) ** (1 / 3)
    if algorithm == "d25_local_fusion":
        return (p * (1 + 4 * phi) ** 2 / 16) ** (1 / 3)
    if algorithm == "s25_no_elision":
        # argmin_c of 4/sqrt(pc) + 3*phi*c/p: c* = (4p/(9 phi^2))^(1/3)
        return (p / (3 * phi / 2) ** 2) ** (1 / 3) if phi > 0 else float(p)
    if algorithm == "s25_replication_reuse":
        return (p / (2 * phi) ** 2) ** (1 / 3) if phi > 0 else float(p)
    raise ValueError(f"unknown algorithm {algorithm!r}")


# Training-step coefficient table: per-processor trainstep words / (n r)
#   1.5D cells:  A/c          + B (c-1)/p
#   2.5D cells:  A/sqrt(p c)  + B (c-1)/p
# with A = a0 + a_phi * phi and B = b0 + b_phi * phi.  Derived by summing
# words_fusedmm + words_fusedmm_bwd (= 2x fusedmm + 2x spmm) per cell;
# kept closed-form so optimal_c_trainstep stays analytic like Table IV.
_TRAINSTEP_COEFS = {
    "d15_no_elision":        (6.0, 0.0, 6.0, 0.0),
    "d15_replication_reuse": (6.0, 0.0, 4.0, 0.0),
    "d15_local_fusion":      (4.0, 0.0, 6.0, 0.0),
    "s15_no_elision":        (0.0, 18.0, 6.0, 0.0),
    "s15_replication_reuse": (0.0, 18.0, 4.0, 0.0),
    "s15_local_fusion":      (0.0, 14.0, 4.0, 0.0),
    "d25_no_elision":        (6.0, 18.0, 6.0, 0.0),
    "d25_replication_reuse": (6.0, 18.0, 4.0, 0.0),
    "d25_local_fusion":      (4.0, 14.0, 6.0, 0.0),
    "s25_no_elision":        (12.0, 0.0, 0.0, 8.0),
    "s25_replication_reuse": (10.0, 0.0, 0.0, 8.0),
}


def optimal_c_trainstep(algorithm: str, *, p: int, phi: float = 0.0,
                        session: bool = False) -> float:
    """Closed-form optimal replication factor for a TRAINING STEP.

    The backward pass doubles the dense traffic (the dual FusedMM plus
    two transpose-SpMMs re-ship the dense operands), which shifts the
    optimum away from Table IV's forward-only c*: e.g. d15 "reuse" drops
    from sqrt(2p) to sqrt(1.5p) — the extra backward shift words punish
    large c harder than the (session-elidable) replication does.
    ``session=True`` removes the backward's replayed gathers
    (SESSION_BWD_ELIDED), pushing c* back up.
    """
    if algorithm not in _TRAINSTEP_COEFS:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    a0, a_phi, b0, b_phi = _TRAINSTEP_COEFS[algorithm]
    family, _ = FAMILY_ELISION[algorithm]
    a = a0 + a_phi * phi
    b = b0 + b_phi * phi
    if session:
        b = b - SESSION_BWD_ELIDED[family]
    if b <= 0 or a <= 0:
        return float(p)
    if family in ("d15", "s15"):
        return math.sqrt(a * p / b)
    return (a * a * p / (4 * b * b)) ** (1 / 3)


def feasible_cs(algorithm: str, p: int, r: int = 0):
    """Integer replication factors the algorithm supports on p processors."""
    out = []
    for c in range(1, p + 1):
        if p % c:
            continue
        if algorithm.startswith(("d25", "s25")):
            q = p // c
            s = math.isqrt(q)
            if s * s != q:
                continue
        out.append(c)
    return out


def best_c(algorithm: str, *, p: int, n: int, r: int, nnz: int) -> CommCost:
    """Best feasible integer c by exhaustive evaluation of Table III."""
    best = None
    for c in feasible_cs(algorithm, p):
        cost = words_fusedmm(algorithm, p=p, c=c, n=n, r=r, nnz=nnz)
        if best is None or cost.words < best.words:
            best = cost
    if best is None:
        raise ValueError(f"no feasible c for {algorithm} at p={p}")
    return best


def select_algorithm(*, p: int, n: int, r: int, nnz: int,
                     candidates=ALGORITHMS) -> Dict[str, CommCost]:
    """Rank candidate algorithms at their best c (the paper's Fig. 6 rule)."""
    costs = {}
    for alg in candidates:
        try:
            costs[alg] = best_c(alg, p=p, n=n, r=r, nnz=nnz)
        except ValueError:
            continue
    return dict(sorted(costs.items(), key=lambda kv: kv[1].words))


def family_feasible(family: str, *, m: int, n: int, r: int, p: int,
                    c: int) -> bool:
    """Can `family` run (m x n, width r) on p processors at replication c?

    Mirrors the divisibility asserted by the planners in repro.core:
      d15: m % p == 0 and n % p == 0          (dense row blocks)
      s15: m % p == 0 and r % p == 0          (column-split dense)
      d25: p/c a perfect square G^2, m,n % Gc == 0 and r % G == 0
      s25: p/c a perfect square G^2, m,n % G == 0 and r % Gc == 0
    """
    if c < 1 or p % c:
        return False
    if family == "d15":
        return m % p == 0 and n % p == 0
    if family == "s15":
        return m % p == 0 and r % p == 0
    if family in ("d25", "s25"):
        g = math.isqrt(p // c)
        if g * g * c != p:
            return False
        if family == "d25":
            return m % (g * c) == 0 and n % (g * c) == 0 and r % g == 0
        return m % g == 0 and n % g == 0 and r % (g * c) == 0
    raise ValueError(f"unknown family {family!r}")


@dataclasses.dataclass(frozen=True)
class AlgorithmChoice:
    """Result of the `algorithm="auto"` dispatch rule (paper Fig. 6)."""
    family: str       # one of FAMILIES — the executor module to use
    elision: str      # FusedMM strategy for that family
    c: int            # replication factor
    cost: CommCost    # Table-III words/messages at (family, elision, c)


def choose_algorithm(*, m: int, n: int, nnz: int, r: int, p: int,
                     c: int | None = None,
                     families=FAMILIES) -> AlgorithmChoice:
    """Pick the cheapest feasible (family, elision, c) by Table III.

    Implements the paper's bandwidth-cost dispatch: evaluate the per-
    processor word count of every Table-III algorithm at every feasible
    replication factor (or at the caller-pinned `c`), filter by the
    planners' divisibility constraints, and return the minimizer.  Low
    phi = nnz/(n*r) favors the sparse-shifting/replicating families,
    high phi the dense ones (Fig. 6).
    """
    best = None
    for name in ALGORITHMS:
        family, elision = FAMILY_ELISION[name]
        if family not in families:
            continue
        cs = [c] if c is not None else list(range(1, p + 1))
        for ci in cs:
            if p % ci or not family_feasible(family, m=m, n=n, r=r, p=p,
                                             c=ci):
                continue
            cost = words_fusedmm(name, p=p, c=ci, n=n, r=r, nnz=nnz)
            if best is None or cost.words < best.cost.words:
                best = AlgorithmChoice(family, elision, ci, cost)
    if best is None:
        raise ValueError(
            f"no feasible algorithm for m={m} n={n} r={r} p={p} c={c} "
            f"among families {families}")
    return best


def flops_fusedmm(nnz: int, r: int) -> int:
    """Local FLOPs for one FusedMM: SDDMM (2r per nnz) + SpMM (2r per nnz)."""
    return 4 * nnz * r


# ---------------------------------------------------------------------------
# Local kernel tiling model (VMEM residency + grid amortization)
# ---------------------------------------------------------------------------
#
# The reference's TPU tiling model, kept number for number so that the
# port's plans (r_tile, blocks_per_step) equal the reference's.  Its
# budgets describe a TPU core, not the H100; the CUDA kernels size their
# own shared memory (kernels/csrc/common.cuh).

# Per-core VMEM on current TPUs is ~16 MiB; leave half for Pallas double
# buffering, semaphores and the compiler's own temporaries.
VMEM_BUDGET_BYTES = 8 * 1024 * 1024

# Target contraction depth of the one-hot matmul: the MXU is 128x128, so
# K >= 256 keeps the systolic array busy; beyond ~1024 the gather cost of
# the nonzero rows dominates.
_TARGET_STEP_NNZ = 512


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Static tiling knobs for the local Pallas kernels.

    r_tile           -- width of the embedding-dimension slab brought into
                        VMEM per grid step (divides r)
    blocks_per_step  -- how many nonzero blocks one grid step consumes
                        (divides nblocks; all blocks of a step must share a
                        tile_base, see sparse.pack_row_tiled(group=...))
    """
    r_tile: int
    blocks_per_step: int

    def kernel_kwargs(self) -> dict:
        """Keyword arguments for the ops.py kernel wrappers."""
        return dict(r_tile=self.r_tile, blocks_per_step=self.blocks_per_step)


def _divisors_desc(x: int):
    return sorted((d for d in range(1, x + 1) if x % d == 0), reverse=True)


def groupable_blocks_per_step(tile_base, nz_block: int, *,
                              cap: int | None = None) -> int:
    """Largest feasible blocks_per_step for a concrete pack.

    ``tile_base`` is a (..., nb) array of per-block window bases; a group
    size g is feasible iff every aligned run of g consecutive blocks (in
    every leading slot) shares one base, so a single output window covers
    the whole grid step.  Returns the largest feasible divisor of nb whose
    merged step stays near the MXU-friendly contraction depth.
    """
    tb = np.asarray(tile_base)
    nb = tb.shape[-1]
    if nb == 0:
        return 1
    flat = tb.reshape(-1, nb)
    cap = cap if cap is not None else max(_TARGET_STEP_NNZ // max(nz_block, 1),
                                          1)
    for g in _divisors_desc(nb):
        if g > cap:
            continue
        groups = flat.reshape(flat.shape[0], nb // g, g)
        if bool((groups == groups[..., :1]).all()):
            return g
    return 1


def choose_tiling(*, n_b: int, r: int, nb: int, k: int, row_tile: int,
                  itemsize: int = 4,
                  vmem_budget: int = VMEM_BUDGET_BYTES,
                  tile_base=None) -> Tiling:
    """Pick (r_tile, blocks_per_step) from VMEM budget and pack statistics.

    The dominant VMEM resident per grid step is the local B tile slab
    (n_b x r_tile) plus one (row_tile x r_tile) window each for the
    gathered-A / accumulator sides, all double-buffered by the Pallas
    pipeline.  r_tile is the largest divisor of r that fits; the lane width
    (128) is preferred as a lower bound so slabs stay MXU-aligned.

    blocks_per_step amortizes grid/dispatch overhead for small-k packs and
    deepens the one-hot matmul contraction; it is only raised when a
    concrete ``tile_base`` proves the pack groupable (traced packs fall
    back to 1 — distributed planners pass pack stats at plan time).
    """
    per_col = 2 * (n_b + 2 * row_tile) * itemsize  # x2: double buffering
    r_tile = r
    for d in _divisors_desc(r):
        r_tile = d
        if d * per_col <= vmem_budget or d <= 128:
            break
    if tile_base is None:
        bps = 1
    else:
        bps = groupable_blocks_per_step(tile_base, k)
        if nb % bps:
            bps = 1
    return Tiling(r_tile=r_tile, blocks_per_step=bps)
