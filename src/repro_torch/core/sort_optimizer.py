"""SORT configuration optimizer (paper §3.2).

A copy of ``repro.core.sort_optimizer`` (numpy-only), kept in the port so
that it imports nothing of the JAX package.

Finds the canonical l-layer radix-tree fan-outs ``a_0..a_{l-1}`` minimizing the
expected space

    min  2^{a_0} + sum_{i=1}^{l-1} N(i) * p(i) * 2^{a_i}
    s.t. a_0 + ... + a_{l-1} >= x

where N(i) = 2^{x - (a_i+...+a_{l-1})} is the max node count at layer i and
p(i) = 1 - C(2^x - S_i, n)/C(2^x, n) is the hypergeometric probability that a
layer-i node is instantiated, S_i = 2^{a_i+...+a_{l-1}}.

Solved exactly by the paper's dynamic program over prefix sums
``s_i = a_0+...+a_i`` (Equation 1), using Lemma 1 (``s_{l-1} = x``).

Pure numpy / Python — runs on host at graph-construction time (paper: <1 s on
twitter-2010; ours is O(l·x²) transitions with O(1) lgamma probability
evaluation instead of the paper's O(n) product).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "SortConfig",
    "optimize_sort",
    "expected_space",
    "uniform_config",
    "veb_config",
    "node_probability",
]


@dataclass(frozen=True)
class SortConfig:
    """A canonical l-layer radix tree configuration."""

    fanout_bits: Tuple[int, ...]  # a_i per layer, pruned of a_i == 0
    key_bits: int                 # x: bit length of the ID universe
    n: int                        # number of IDs the optimizer assumed
    expected_space: float         # objective value (pointer-slot count)

    @property
    def layers(self) -> int:
        return len(self.fanout_bits)

    @property
    def prefix_bits(self) -> Tuple[int, ...]:
        """s_i = a_0 + ... + a_i."""
        out, acc = [], 0
        for a in self.fanout_bits:
            acc += a
            out.append(acc)
        return tuple(out)

    @property
    def suffix_bits(self) -> Tuple[int, ...]:
        """Bits indexed strictly below layer i: x - s_i."""
        return tuple(self.key_bits - s for s in self.prefix_bits)


_EXACT_LIMIT = 1 << 22


def _log_comb_ratio(u: float, S: float, n: int) -> float:
    """ln[ C(u - S, n) / C(u, n) ].

    Exact product forms when either n or S is small (lgamma differences of
    huge arguments lose ~1e-5 absolute precision, which swamps tiny
    probabilities); Stirling-lgamma otherwise. Returns -inf when u - S < n
    (the node is then created with probability 1).
    """
    if u - S < n:
        return -math.inf
    if n <= _EXACT_LIMIT:
        # prod_{t<n} (u - S - t) / (u - t)
        t = np.arange(n, dtype=np.float64)
        return float(np.sum(np.log1p(-S / (u - t))))
    if S <= _EXACT_LIMIT:
        # C(u-S, n)/C(u, n) = prod_{t<S} (u - n - t) / (u - t)
        t = np.arange(int(S), dtype=np.float64)
        return float(np.sum(np.log1p(-n / (u - t))))
    ld = np.longdouble
    u, S = ld(u), ld(S)
    lg = _lgamma_ld
    return float(lg(u - S + 1) - lg(u - S - n + 1) - lg(u + 1) + lg(u - n + 1))


def _lgamma_ld(z: np.longdouble) -> np.longdouble:
    """lgamma for longdouble via Stirling series (z is huge here: >= 1).

    For z >= 1e7 uses Stirling with 3 correction terms (error << 1e-20
    relative); below that defers to math.lgamma (double is exact enough for
    small z).
    """
    zf = float(z)
    if zf < 1e7:
        return np.longdouble(math.lgamma(zf))
    ld = np.longdouble
    z = ld(z)
    half_log_2pi = ld(0.91893853320467274178032973640562)
    out = (z - ld(0.5)) * np.log(z) - z + half_log_2pi
    out += ld(1.0) / (ld(12.0) * z)
    out -= ld(1.0) / (ld(360.0) * z ** 3)
    out += ld(1.0) / (ld(1260.0) * z ** 5)
    return out


def node_probability(x: int, suffix_bits: int, n: int) -> float:
    """p(i): probability a layer-i node (interval size S = 2^suffix_bits) is
    instantiated when n distinct uniform IDs are drawn from [0, 2^x)."""
    if suffix_bits >= x:
        return 1.0
    u = math.pow(2.0, x)
    S = math.pow(2.0, suffix_bits)
    if u - S < n:
        return 1.0
    lr = _log_comb_ratio(u, S, n)
    # p = 1 - exp(lr); use expm1 for precision when lr ~ 0.
    return float(-math.expm1(lr)) if lr > -700 else 1.0


def expected_space(fanout_bits: Sequence[int], x: int, n: int) -> float:
    """Objective: expected pointer-slot count of the configuration.

    Layer 0 contributes 2^{a_0} (root always exists); layer i>0 contributes
    N(i) * p(i) * 2^{a_i} with N(i) = 2^{x - suffix(i)}, suffix(i) = bits
    strictly below *and including* layer i's fanout.
    """
    a = list(fanout_bits)
    l = len(a)
    if sum(a) < x:
        raise ValueError(f"configuration {a} cannot cover {x}-bit universe")
    total = math.pow(2.0, a[0])
    for i in range(1, l):
        suffix = sum(a[i:])            # a_i + ... + a_{l-1}
        prefix = sum(a[:i])            # bits consumed above layer i
        n_nodes = math.pow(2.0, max(x - suffix, 0))
        # Nodes beyond the universe are never created (paper case (2)).
        n_nodes = min(n_nodes, math.pow(2.0, prefix))
        p = node_probability(x, min(suffix, x), n)
        total += math.pow(2.0, a[i]) * min(n_nodes * p, float(n))
        # min(., n): at most n nodes can be instantiated at any layer — the
        # paper's expectation already satisfies N(i)p(i) <= n; the clamp only
        # guards float slack.
    return total


def optimize_sort(
    n: int,
    key_bits: int,
    layers: int,
    max_root_bits: int | None = None,
) -> SortConfig:
    """Solve the paper's DP (Equation 1) for the optimal fan-outs.

    g(i, j) = min space of the first i+1 layers given s_i = j, with
    g(0, j) = 2^j and transition cost h(j, k) = 2^j * p(suffix = x - k).
    Lemma 1 pins s_{l-1} = x. Backtracking recovers a_i = s_i - s_{i-1};
    zero-fanout layers are pruned (paper §3.2 "Tuning the depth").

    ``max_root_bits`` optionally caps a_0 (practical memory guard for the
    root pointer array; None = uncapped, faithful to the paper).
    """
    if n <= 0:
        raise ValueError("n must be positive")
    x = int(key_bits)
    l = max(1, min(int(layers), x))

    # h_cost[k] = multiplier term (1 - comb ratio) for a parent prefix of k
    # bits: nodes at the child layer have interval size 2^{x-k}; the expected
    # *count* of instantiated child-layer nodes is 2^k * p — but in the DP the
    # 2^j factor carries the array size, and N(i) = 2^{s_{i-1}} = 2^k nodes
    # each w.p. p(x - k)  →  term = 2^j * [N(i)p(i) / 2^{s_i - j} ... ]
    # Following the paper's simplified f: term_i = 2^{s_i} * p(x - s_{i-1}).
    p_of_prefix = [node_probability(x, x - k, n) for k in range(0, x + 1)]

    NEG = math.inf
    # g[j] for current layer; parent[i][j] = argmin k
    g_prev = [math.pow(2.0, j) for j in range(x + 1)]
    if max_root_bits is not None:
        for j in range(max_root_bits + 1, x + 1):
            g_prev[j] = NEG
    parents: List[List[int]] = []

    for i in range(1, l):
        g_cur = [NEG] * (x + 1)
        par = [-1] * (x + 1)
        # prefix minima of g_prev with the p factor applied lazily:
        # cost(j, k) = g_prev[k] + 2^j * p_of_prefix[k]; for fixed j the best
        # k must be found over k <= j. O(x^2) total per layer (x <= 64).
        for j in range(0, x + 1):
            pow2j = math.pow(2.0, j)
            best, bestk = NEG, -1
            for k in range(0, j):
                if g_prev[k] == NEG:
                    continue
                c = g_prev[k] + pow2j * p_of_prefix[k]
                if c < best:
                    best, bestk = c, k
            # k == j: a zero-width layer is *pruned* (paper §3.2 "Tuning the
            # depth"), so skipping a layer is free — this makes the DP exact
            # over the family of trees with AT MOST l layers.
            if g_prev[j] != NEG and g_prev[j] < best:
                best, bestk = g_prev[j], j
            g_cur[j] = best
            par[j] = bestk
        parents.append(par)
        g_prev = g_cur

    # Lemma 1: s_{l-1} = x.
    best_val = g_prev[x]
    s = [0] * l
    s[l - 1] = x
    for i in range(l - 1, 0, -1):
        s[i - 1] = parents[i - 1][s[i]]
    fanouts = [s[0]] + [s[i] - s[i - 1] for i in range(1, l)]
    fanouts = [a for a in fanouts if a > 0]  # prune zero layers
    if not fanouts:
        fanouts = [x]
    return SortConfig(
        fanout_bits=tuple(fanouts),
        key_bits=x,
        n=n,
        expected_space=float(best_val),
    )


def uniform_config(n: int, key_bits: int, layers: int) -> SortConfig:
    """Paper's uniform-tree baseline: equal fan-out 2^{ceil(x/l)}."""
    x, l = int(key_bits), max(1, int(layers))
    a = math.ceil(x / l)
    # uniform-tree uses fanout 2^{ceil(x/l)} at *every* layer (may overshoot x)
    fan = [a] * l
    return SortConfig(tuple(fan), x, n, expected_space(fan, x, n))


def veb_config(n: int, key_bits: int) -> SortConfig:
    """Paper's vEB baseline: recursively halve the bit budget.

    x -> top ceil(x/2) bits, then recurse on the lower half; yields fanouts
    (x/2, x/4, ..., 1) — depth O(lg x) = O(lglg u).
    """
    x = int(key_bits)
    fan: List[int] = []
    rem = x
    while rem > 0:
        top = (rem + 1) // 2
        fan.append(top)
        rem -= top
    return SortConfig(tuple(fan), x, n, expected_space(fan, x, n))
