"""Comparison topologies (paper §III / §VIII, Table V).

* Slim Fly (MMS graphs, diameter 2) -- the paper's main competitor.
* Dragonfly (balanced and "equivalent" variants, diameter 3).
* HyperX / Flattened Butterfly (2-D Hamming graph, diameter 2).
* k-ary n-tree Fat tree (indirect; switch-level graph).
* Jellyfish (random regular graph).

A copy of the JAX package's ``core/topologies.py`` (which is numpy only).
"""

from __future__ import annotations

import numpy as np

from .gf import GF, is_prime_power
from .graph import Graph, GraphBuilder

__all__ = [
    "build_slimfly",
    "build_dragonfly",
    "build_hyperx",
    "build_fat_tree",
    "build_jellyfish",
    "build_paley",
    "build_polarstar",
    "paper_table5_configs",
]


# ----------------------------------------------------------------------------
# Slim Fly: McKay-Miller-Siran graphs, N = 2 q^2, k = (3q - delta)/2
# ----------------------------------------------------------------------------

def _mms_generator_sets(gf: GF):
    """Hafner's generator sets X1 (subgraph 0) and X2 (subgraph 1).

    q = 4w + delta, delta in {-1, +1}:  (delta = 0, q = 2^s, is not
    implemented; those configurations are rare and unused in the paper.)
      delta = +1: X1 = even powers of a primitive element xi, X2 = odd powers.
      delta = -1: X1 = {xi^0, xi^2, .., xi^(2w-2)} + {xi^(2w-1), xi^(2w+1), ..,
                  xi^(4w-3)}, X2 = xi * X1.  Both are symmetric (X = -X).
    """
    q = gf.q
    if (q - 1) % 4 == 0:
        delta = 1
    elif (q + 1) % 4 == 0:
        delta = -1
    else:
        raise NotImplementedError(f"Slim Fly delta=0 (q={q}) not supported")
    xi = gf.primitive_element()
    powers = [1]
    for _ in range(q - 2):
        powers.append(int(gf.mul(powers[-1], xi)))
    if delta == 1:
        x1 = powers[0::2]
        x2 = powers[1::2]
    else:
        w = (q + 1) // 4
        x1 = powers[0:2 * w - 1:2] + powers[2 * w - 1:4 * w - 2:2]
        x2 = [int(gf.mul(xi, v)) for v in x1]
    # sanity: symmetric generator sets
    for xs in (x1, x2):
        s = set(xs)
        assert all(int(gf.neg(np.int32(v))) in s for v in s), "generator set not symmetric"
    return np.array(sorted(x1)), np.array(sorted(x2)), delta


def build_slimfly(q: int) -> Graph:
    """Slim Fly MMS(q): 2 q^2 routers, radix (3q - delta)/2, diameter 2."""
    if not is_prime_power(q):
        raise ValueError("q must be a prime power")
    gf = GF(q)
    x1, x2, delta = _mms_generator_sets(gf)
    n = 2 * q * q

    def vid(t: int, a: int, b: int) -> int:
        return t * q * q + a * q + b

    b = GraphBuilder(f"SF({q})", n)
    x1set = set(int(v) for v in x1)
    x2set = set(int(v) for v in x2)
    # local (intra-column) Cayley edges
    for x in range(q):
        for y in range(q):
            for yp in range(y + 1, q):
                if int(gf.sub(np.int32(y), np.int32(yp))) in x1set:
                    b.add_edge(vid(0, x, y), vid(0, x, yp))
                if int(gf.sub(np.int32(y), np.int32(yp))) in x2set:
                    b.add_edge(vid(1, x, y), vid(1, x, yp))
    # cross edges: (0, x, y) ~ (1, m, c) iff y = m x + c
    for x in range(q):
        for m in range(q):
            mx = int(gf.mul(np.int32(m), np.int32(x)))
            for c in range(q):
                y = int(gf.add(np.int32(mx), np.int32(c)))
                b.add_edge(vid(0, x, y), vid(1, m, c))
    g = b.freeze()
    g.params.update({"q": q, "delta": delta, "radix": (3 * q - delta) // 2})
    return g


# ----------------------------------------------------------------------------
# Dragonfly (canonical, one global link per group pair)
# ----------------------------------------------------------------------------

def build_dragonfly(a: int, h: int) -> Graph:
    """Dragonfly: groups of `a` fully-connected routers, h global links per
    router, G = a*h + 1 groups (one global link between every group pair)."""
    num_groups = a * h + 1
    n = num_groups * a
    b = GraphBuilder(f"DF(a={a},h={h})", n)
    for g in range(num_groups):
        base = g * a
        for i in range(a):
            for j in range(i + 1, a):
                b.add_edge(base + i, base + j)
    # consecutive allocation: port p (0..a*h-1) of group g -> group g+p+1 (mod G)
    for g in range(num_groups):
        for p in range(a * h):
            gp = (g + p + 1) % num_groups
            if gp < g:
                continue  # add each inter-group edge once (from the lower group)
            p_back = num_groups - 2 - p  # the mirror port in gp
            b.add_edge(g * a + p // h, gp * a + p_back // h)
    g = b.freeze()
    g.params.update({"a": a, "h": h, "groups": num_groups, "radix": a - 1 + h})
    return g


# ----------------------------------------------------------------------------
# HyperX (2-D Hamming graph / generalized Flattened Butterfly)
# ----------------------------------------------------------------------------

def build_hyperx(s1: int, s2: int) -> Graph:
    n = s1 * s2
    b = GraphBuilder(f"HX({s1}x{s2})", n)
    for i in range(s1):
        for j in range(s2):
            u = i * s2 + j
            for jp in range(j + 1, s2):
                b.add_edge(u, i * s2 + jp)
            for ip in range(i + 1, s1):
                b.add_edge(u, ip * s2 + j)
    g = b.freeze()
    g.params.update({"s1": s1, "s2": s2, "radix": s1 + s2 - 2})
    return g


# ----------------------------------------------------------------------------
# Fat tree: k-ary n-tree (switch-level graph; endpoints hang off level 0)
# ----------------------------------------------------------------------------

def build_fat_tree(k: int, n_levels: int = 3) -> Graph:
    """k-ary n-tree: n_levels * k^(n_levels-1) switches, switch radix 2k
    (k down + k up; top level uses only k down).  Level-0 switches are the
    leaf/edge switches (k endpoints each in the simulator)."""
    per_level = k ** (n_levels - 1)
    n = n_levels * per_level

    def sid(level: int, w: int) -> int:
        return level * per_level + w

    b = GraphBuilder(f"FT(k={k},n={n_levels})", n)
    # switch (l, w) ~ (l+1, w') iff digits of w and w' agree except digit l
    for lvl in range(n_levels - 1):
        stride = k ** lvl
        for w in range(per_level):
            digit = (w // stride) % k
            base = w - digit * stride
            for d in range(k):
                b.add_edge(sid(lvl, w), sid(lvl + 1, base + d * stride))
    g = b.freeze()
    g.params.update({"k": k, "levels": n_levels, "radix": 2 * k,
                     "hosts": k ** n_levels, "leaf_switches": per_level})
    return g


# ----------------------------------------------------------------------------
# PolarStar (Lakhotia et al. 2023): star product ER_q * Paley(qj), diameter 3
# ----------------------------------------------------------------------------

def build_paley(q: int) -> Graph:
    """Paley graph QR(q): vertices GF(q), x ~ y iff x - y is a nonzero
    square.  Requires a prime power q = 1 (mod 4) so that -1 is a square and
    adjacency is symmetric.  (q-1)/2-regular, diameter 2, self-complementary:
    x -> nu*x for any non-residue nu maps the graph onto its complement --
    the property the PolarStar star product leans on."""
    if not is_prime_power(q) or q % 4 != 1:
        raise ValueError("Paley graph needs a prime power q = 1 (mod 4)")
    gf = GF(q)
    b = GraphBuilder(f"Paley({q})", q)
    residues = np.where(gf.squares)[0].astype(np.int32)
    for x in range(q):
        for s in residues:
            y = int(gf.add(np.int32(x), s))
            if x < y:
                b.add_edge(x, y)
    g = b.freeze()
    g.params.update({"q": q, "radix": (q - 1) // 2})
    return g


def build_polarstar(q: int, qj: int) -> Graph:
    """PolarStar-flavored star product PS(q, qj) = ER_q * Paley(qj): the
    diameter-3 topology of "PolarStar: Expanding the Scalability Horizon of
    Diameter-3 Networks" with the Paley join graph.

    Supernodes are the N_s = q^2+q+1 vertices of the polarity graph ER_q
    (the PolarFly structure graph); each holds a copy of the Paley(qj) join
    graph.  Every ER edge {u, v} (oriented u < v) contributes the perfect
    matching (u, x) ~ (v, nu * x) for one fixed quadratic non-residue nu of
    GF(qj) -- the Paley complement isomorphism.

    Diameter 3: inside a supernode, and across one ER edge, the Paley copy
    finishes in <= 2 extra hops (Paley has diameter 2).  For supernodes at
    ER distance 2 (unique common neighbor w), writing sigma(x) = nu * x and
    QR / NQR for the (non-)residue sets, the three <= 3-hop shapes
    cross-cross-intra, cross-intra-cross and intra-cross-cross from (u, x)
    reach sigma^2(x) + QR, sigma(N[sigma(x)]) = sigma^2(x) + NQR and
    sigma^2(N[x]) = sigma^2(x) + NQR in supernode v -- together all of
    GF(qj), precisely because nu is a non-residue.  (Per-edge random
    multipliers break this whenever a 2-path composes two residue
    multipliers; identity matchings always fail it.)  Verified empirically
    by tests/test_metrics.py::test_polarstar_diameter_3.

    N = (q^2+q+1) * qj at radix q + 1 + (qj-1)/2 -- e.g. PS(7, 49) packs
    2793 routers at radix 32 where PolarFly PF(31) packs 993.  Vertices in
    the q+1 quadric supernodes have one port fewer (ER self-loops are not
    replicated; the diameter bound above never uses them).
    """
    from .polarfly import build_polarfly

    gj = build_paley(qj)
    gf = GF(qj)
    nu = next(x for x in range(1, qj) if not gf.squares[x])
    pf = build_polarfly(q)
    gs = pf.graph
    b = GraphBuilder(f"PS({q},{qj})", gs.n * qj)

    def vid(u: int, x: int) -> int:
        return u * qj + x

    for u in range(gs.n):  # intra-supernode join-graph copies
        for x, y in gj.edge_list:
            b.add_edge(vid(u, int(x)), vid(u, int(y)))
    sigma = [int(gf.mul(np.int32(nu), np.int32(x))) for x in range(qj)]
    for u, v in gs.edge_list:  # cross matchings (u, x) ~ (v, sigma(x))
        for x in range(qj):
            b.add_edge(vid(int(u), x), vid(int(v), sigma[x]))
    g = b.freeze()
    g.params.update({"q": q, "qj": qj, "supernodes": gs.n,
                     "radix": q + 1 + (qj - 1) // 2})
    return g


# ----------------------------------------------------------------------------
# Jellyfish: random k-regular graph
# ----------------------------------------------------------------------------

def build_jellyfish(n: int, k: int, seed: int = 0) -> Graph:
    """Random regular graph via stub matching with rejection + repair."""
    if n * k % 2:
        raise ValueError("n*k must be even")
    rng = np.random.default_rng(seed)
    for _ in range(200):
        stubs = np.repeat(np.arange(n), k)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        b = GraphBuilder(f"JF(n={n},k={k})", n)
        bad = []
        for u, v in pairs:
            u, v = int(u), int(v)
            if u == v or b.has_edge(u, v):
                bad.append((u, v))
            else:
                b.add_edge(u, v)
        # repair bad pairs (self loops / duplicates) with double-edge swaps:
        # replace an existing edge (x, y) with (u, x) and (v, y); for a
        # self-loop pair u == v this still restores both of u's stubs.
        ok = True
        for u, v in bad:
            fixed = False
            for _ in range(2000):
                x = int(rng.integers(n))
                nbx = sorted(b.adj[x])
                if not nbx:
                    continue
                y = int(nbx[int(rng.integers(len(nbx)))])
                if x in (u, v) or y in (u, v):
                    continue
                if b.has_edge(u, x) or b.has_edge(v, y):
                    continue
                if u == v and b.has_edge(u, y):
                    continue  # self-loop pair adds (u,x) AND (u,y)
                b.adj[x].discard(y)
                b.adj[y].discard(x)
                b.add_edge(u, x)
                b.add_edge(v, y)
                fixed = True
                break
            if not fixed:
                ok = False
                break
        if ok:
            g = b.freeze()
            g.params.update({"radix": k})
            return g
    raise RuntimeError("failed to build random regular graph")


def paper_table5_configs(seed: int = 0):
    """The six topologies of Table V at the paper's scales."""
    from .polarfly import build_polarfly

    pf = build_polarfly(31).graph  # 993 routers, radix 32
    return {
        "PF": pf,
        "SF": build_slimfly(23),            # 1058 routers, radix 35
        "DF1": build_dragonfly(12, 6),      # 876 routers, radix 17
        "DF2": build_dragonfly(6, 27),      # 978 routers, radix 32
        "JF": build_jellyfish(993, 32, seed=seed),
        "FT": build_fat_tree(18, 3),        # 972 switches, radix 36
    }
