"""Analytic communication accounting (paper Tables 2-4), classic and
s-step PCG.

Counts the collectives the way the paper does:

  DiSCO-S, per outer iteration : broadcast w_k (d) + reduceAll grad (d)
  DiSCO-S, per PCG iteration   : broadcast u_t (d) + reduceAll H u_t (d)
  DiSCO-F, per outer iteration : reduceAll margins (n) + final reduce v (d_j)
  DiSCO-F, per PCG iteration   : reduceAll (n) + 2 scalar reduceAlls

``rounds`` is the paper's MPI view; ``spmd_collectives`` counts the
all-reduces an SPMD program runs (a broadcast+reduceAll pair of a
replicated vector is one all-reduce).
"""
from __future__ import annotations

import dataclasses

BYTES_PER_FLOAT = 4  # f32 throughout


@dataclasses.dataclass
class CommLedger:
    rounds: int = 0          # paper-style rounds (MPI view)
    floats: int = 0          # total vector elements moved through collectives
    spmd_collectives: int = 0

    def add(self, rounds: int, floats: int, spmd: int | None = None):
        self.rounds += rounds
        self.floats += floats
        self.spmd_collectives += spmd if spmd is not None else rounds

    @property
    def bytes(self) -> int:
        return self.floats * BYTES_PER_FLOAT

    def merged(self, other: "CommLedger") -> "CommLedger":
        return CommLedger(self.rounds + other.rounds,
                          self.floats + other.floats,
                          self.spmd_collectives + other.spmd_collectives)


def disco_s_outer_cost(d: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for one outer iteration excluding PCG."""
    return 2, 2 * d, 1


def disco_s_pcg_cost(d: int, iters: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``iters`` classic DiSCO-S PCG
    iterations: per iteration one d-vector broadcast of the probe u_t
    plus one d-vector reduceAll of H u_t (a single SPMD all-reduce)."""
    return 2 * iters, 2 * d * iters, 1 * iters


def disco_f_outer_cost(n: int, d: int, m: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for one DiSCO-F outer iteration excluding
    PCG: the margins reduceAll (n floats) + the final "Reduce an R^{d_j}
    vector" of Algorithm 3 line 12 (d floats total). Under SPMD only the
    margins all-reduce materializes."""
    return 2, n + d, 1


def disco_f_pcg_cost(n: int, iters: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``iters`` classic DiSCO-F PCG
    iterations: one n-vector reduceAll each, plus two scalar reduceAlls
    counted in floats and SPMD collectives but not as vector rounds."""
    return 1 * iters, (n + 2) * iters, 3 * iters


def disco_s_sstep_cost(d: int, s: int, rounds: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``rounds`` s-step DiSCO-S rounds: per
    round the (d, s+1) trial basis is broadcast and the (d, s+1) batched
    HVP reduced, the pair of one classic iteration carrying s+1 vectors;
    the Gram system is replicated and costs nothing. Under SPMD the pair
    is one all-reduce per round."""
    k = s + 1
    return 2 * rounds, 2 * d * k * rounds, 1 * rounds


def disco_f_sstep_cost(n: int, s: int, rounds: int) -> tuple[int, int, int]:
    """(rounds, floats, spmd) for ``rounds`` s-step DiSCO-F rounds: one
    (n, s) reduceAll of the batched pass A (H p_prev is carried from the
    previous round), plus one small reduceAll of the Gram payload
    (2(s+1)^2 + (s+1) floats), counted in floats and SPMD collectives but
    not as a vector round, as the classic path's scalar reduceAlls."""
    k = s + 1
    return 1 * rounds, (n * s + 2 * k * k + k) * rounds, 2 * rounds
