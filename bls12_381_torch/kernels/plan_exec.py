"""Expression plans: a whole tower operation as one static Fp DAG, one launch.

`plan_exec` replaces `bls12_381_tpu/kernels/plan_exec.py::plan_exec_pallas`
(default body `_plan_kernel`, the level-batched evaluator run by
`run_plan(variant="vector")`).  Source: `csrc/plan_exec.cu` on
`csrc/montgomery.cuh` with the Fp field of `csrc/fp384.cuh`.

The DAG and the plan constructors are the JAX package's, copied: nodes are
`in`, `add`, `sub`, `neg` and `sop` (T <= 6 per node; the constructors chunk
longer sums), interned so that structurally equal nodes are one object.

Design.  `compile_plan` turns a plan into an instruction table once (cached
per plan, uploaded once per device).  Each row is [op, dst slot, n_terms,
src slots...]; rows are ordered by `_plan_schedule`'s level groups (nodes of
one depth, op and term count), and the groups of one depth form a *phase*:
its nodes read only values of earlier phases, so they can all run at once.
A value lives in a slot from its phase to the phase of its last read
(outputs to the end); a slot freed after phase p is taken by a node of a
later phase, never of phase p itself, so `n_slots` is the plan's peak live
count (<= 70 for every plan here, against up to 464 nodes) and a slot index
fits in 8 bits.  The kernel reads the table as one compact byte program
(`_encode_program`: 16-bit phase and row offsets, 8-bit rows; <= 3 KB),
staged into each block's shared memory.

The CUDA kernel gives each block of 192 threads a tile of Lt lanes
(`launch_shape`) and a [slot][word][lane] array of 32-bit words in shared
memory.  The block loads its inputs once, then for each phase its threads
take the phase's (node, lane) items, node-major, one per thread per round:
a `sop` row runs the Montgomery product and reduction of
`csrc/montgomery.cuh`, `add`/`sub`/`neg` the canonical 12-word modular
ripples.  Every thread reads its operands, the block meets at a barrier,
then writes its result, and meets again: a round reads all its sources
before it writes any destination.  The plain version executes the SAME
table the same way, one phase at a time, one vectorised PyTorch call per
level group, so the CPU tests cover the table and its slot reuse and only
the CUDA arithmetic is left for the card.

Bound on the card.  Per lane a plan reads K and writes O values (96 bytes
each as int32 limbs) and does ~2 ((T + 1) 144 + 12) 32-bit multiplies per
T-term sop node, so every plan is bound by its multiplies.  Nothing but the
inputs and outputs touches device memory (no global scratch).  What is left
is the DAG's depth at a narrow batch (each phase costs at least its slowest
node's dependent multiply-add chain, and narrow phases leave threads
waiting at the barrier), and at a wide one the threads an SM holds
resident: slots take ~50 bytes per (value, lane) of shared memory and each
thread up to 85 registers.

Fold mode (`plan_fold`, `compile_plan(..., fold=True)`): the same kernel,
instantiated once more, sums the runs of equal dest along sorted lanes
(the MSM's buckets, the key sets of `ops/aggregate.py`): each lane of a
tile walks a run of lanes, adding each lane's point into an accumulator
held in the plan's slots (one mixed addition a lane), and leaves its
run's segment totals and two partials; the partials are the next level's
lanes (`ops/msm.py` `fold_levels`).  `plan_fold_plain` walks the same
partition with PyTorch.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import heapq
from typing import NamedTuple

import numpy as np
import torch

from .. import limbs
from . import LAUNCHES, build
from .mont import check_launch, device_kind, sm_count, sop_plain

L = limbs.FP.n_limbs
WORDS = 12            # 32-bit words per Fp value in the kernel's slots
MAX_TERMS = 8         # the kernel's sop bound (T p < R)
INSTR_WIDTH = 3 + 2 * MAX_TERMS
OP_CODES = {"add": 1, "sub": 2, "neg": 3, "sop": 4}
MAX_SLOTS = 256            # 8-bit slot indices
THREADS = 192              # per block: the kernel's __launch_bounds__
MAX_LANE_TILE = 64
SMEM_BUDGET = 64 * 1024    # bytes per block: three blocks fit an SM's 228 KB
SM_COUNT = 132             # H100 SXM; the wrapper asks the card
FOLDER_BYTES = 24          # fold mode: a folder's words in shared memory


# ---------------------------------------------------------------------------
# Symbolic DAG
# ---------------------------------------------------------------------------


class Node:
    """Interned DAG node: structural equality is identity (see `_mk`)."""

    __slots__ = ("op", "args")

    def __init__(self, op: str, args: tuple):
        self.op = op      # "in" | "add" | "sub" | "neg" | "sop"
        self.args = args  # in: (k,); add/sub: (Node, Node); neg: (Node,);
        #                 # sop: ((Node, Node), ...)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Node({self.op}, {self.args!r})"


_INTERN: dict = {}


def _mk(op: str, args: tuple) -> Node:
    # args hold only ints or interned Nodes, so the key hashes by identity
    key = (op, args)
    n = _INTERN.get(key)
    if n is None:
        n = _INTERN[key] = Node(op, args)
    return n


def inp(k: int) -> Node:
    return _mk("in", (k,))


def add(a: Node, b: Node) -> Node:
    return _mk("add", (a, b))


def sub(a: Node, b: Node) -> Node:
    return _mk("sub", (a, b))


def neg(a: Node) -> Node:
    return _mk("neg", (a,))


def sop(terms) -> Node:
    """Sum of products, chunked to T <= 6 per node as in the JAX package."""
    terms = tuple(terms)
    if len(terms) <= 6:
        return _mk("sop", terms)
    parts = [sop(terms[i: i + 6]) for i in range(0, len(terms), 6)]
    acc = parts[0]
    for p in parts[1:]:
        acc = add(acc, p)
    return acc


# --- symbolic Fp2 (pairs of nodes), Fp6 (triples of pairs) -----------------


def f2_add(a, b):
    return (add(a[0], b[0]), add(a[1], b[1]))


def f2_sub(a, b):
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def f2_mul_by_xi(a):
    """(1+u) * a  =  (a0 - a1) + (a0 + a1) u."""
    return (sub(a[0], a[1]), add(a[0], a[1]))


def f2_sop(terms):
    """sum_i [xi *]? (x_i * y_i) over symbolic Fp2:
      plain: c0 += x0 y0 - x1 y1            c1 += x0 y1 + x1 y0
      xi:    c0 += x0 (y0-y1) - x1 (y0+y1)  c1 += x0 (y0+y1) + x1 (y0-y1)
    """
    c0g, c1g = [], []
    for x, y, use_xi in terms:
        if not use_xi:
            c0g += [(x[0], y[0]), (neg(x[1]), y[1])]
            c1g += [(x[0], y[1]), (x[1], y[0])]
        else:
            ym, yp = sub(y[0], y[1]), add(y[0], y[1])
            c0g += [(x[0], ym), (neg(x[1]), yp)]
            c1g += [(x[0], yp), (x[1], ym)]
    return (sop(c0g), sop(c1g))


def f2_sqr(a):
    """Complex squaring: ((a0+a1)(a0-a1), 2 a0 a1)."""
    return (
        sop([(add(a[0], a[1]), sub(a[0], a[1]))]),
        sop([(add(a[0], a[0]), a[1])]),
    )


def f2_mul(a, b):
    return (
        sop([(a[0], b[0]), (neg(a[1]), b[1])]),
        sop([(a[0], b[1]), (a[1], b[0])]),
    )


def f2_neg(a):
    return (neg(a[0]), neg(a[1]))


def f2_dbl(a):
    return f2_add(a, a)


def f2_mul_b3(a):
    """3 * b_G2 * a = 12 (1+u) a, by additions."""
    t = f2_mul_by_xi(a)
    d2 = f2_add(t, t)
    d4 = f2_add(d2, d2)
    d8 = f2_add(d4, d4)
    return f2_add(d8, d4)


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_mul(x, y):
    """Schoolbook over v (v^3 = xi), each coordinate one 6-term Fp2 sop:
      c0 = x0 y0 + xi(x1 y2 + x2 y1)
      c1 = x0 y1 + x1 y0 + xi(x2 y2)
      c2 = x0 y2 + x1 y1 + x2 y0
    """
    return (
        f2_sop([(x[0], y[0], False), (x[1], y[2], True), (x[2], y[1], True)]),
        f2_sop([(x[0], y[1], False), (x[1], y[0], False), (x[2], y[2], True)]),
        f2_sop([(x[0], y[2], False), (x[1], y[1], False), (x[2], y[0], False)]),
    )


def f6_mul_by_v(x):
    """v * (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2."""
    return (f2_mul_by_xi(x[2]), x[0], x[1])


def _f6_in(base: int):
    return tuple(
        (inp(base + 2 * i), inp(base + 2 * i + 1)) for i in range(3)
    )


def _flatten12(c0, c1):
    return tuple(n for f2 in (c0 + c1) for n in f2)


def _flatten_f2s(f2s):
    return tuple(n for f2 in f2s for n in f2)


def eval_plan_host(outputs, values, p: int, r: int):
    """A plan's DAG evaluated over Python ints in the Montgomery domain
    (each sop carries the R^-1 of the kernel's reduction): the plan's
    algebra without its limb arithmetic."""
    rinv = pow(r, -1, p)
    cache = {}

    def ev(n):
        if n not in cache:
            if n.op == "in":
                v = values[n.args[0]]
            elif n.op == "add":
                v = ev(n.args[0]) + ev(n.args[1])
            elif n.op == "sub":
                v = ev(n.args[0]) - ev(n.args[1])
            elif n.op == "neg":
                v = -ev(n.args[0])
            elif n.op == "sop":
                v = sum(ev(a) * ev(b) for a, b in n.args) * rinv
            else:
                raise ValueError(f"unknown plan op {n.op!r}")
            cache[n] = v % p
        return cache[n]

    return [ev(o) for o in outputs]


# ---------------------------------------------------------------------------
# The main path's plans (operand layout: 12 Fp rows per Fp12 element,
# [c0.c0.re, c0.c0.im, c0.c1.re, ..., c1.c2.im])
# ---------------------------------------------------------------------------

_PLAN_NAMES: dict = {}


def _named_plan(fn):
    """Cache a plan constructor and record its name for the launch counts."""

    @functools.lru_cache(maxsize=None)
    @functools.wraps(fn)
    def build_plan(*args):
        outputs = fn(*args)
        _PLAN_NAMES[outputs] = fn.__name__ + (
            f"({', '.join(map(str, args))})" if args else "")
        return outputs

    return build_plan


@_named_plan
def fp12_mul_plan():
    """Karatsuba over w (fp12.rs:197-213 algebra): 24 input rows -> 12."""
    a0, a1 = _f6_in(0), _f6_in(6)
    b0, b1 = _f6_in(12), _f6_in(18)
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    t2 = f6_mul(f6_add(a0, a1), f6_add(b0, b1))
    c1 = f6_sub(f6_sub(t2, t0), t1)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    return _flatten12(c0, c1)


def _f12_sqr_sym(a0, a1):
    """(c0 + c1 w)^2 symbolically (fp12.rs:174-185 algebra)."""
    ab = f6_mul(a0, a1)
    t = f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_by_v(a1)))
    c0 = f6_sub(t, f6_add(ab, f6_mul_by_v(ab)))
    c1 = f6_add(ab, ab)
    return c0, c1


@_named_plan
def fp12_sqr_plan():
    """(c0 + c1 w)^2: 12 input rows -> 12."""
    return _flatten12(*_f12_sqr_sym(_f6_in(0), _f6_in(6)))


def _f12_mul_by_045_sym(f0, f1, g0, g4, g5):
    """f * (g0 + g4 (v w) + g5 (v^2 w)) symbolically: the D-twist sparse
    line multiply."""

    def mul_g0(x):
        return tuple(f2_sop([(c, g0, False)]) for c in x)

    def mul_B(x):
        """x * (g4 v + g5 v^2) over Fp6 (y0 = 0 specialization of f6_mul)."""
        return (
            f2_sop([(x[1], g5, True), (x[2], g4, True)]),
            f2_sop([(x[0], g4, False), (x[2], g5, True)]),
            f2_sop([(x[0], g5, False), (x[1], g4, False)]),
        )

    c0 = f6_add(mul_g0(f0), f6_mul_by_v(mul_B(f1)))
    c1 = f6_add(mul_g0(f1), mul_B(f0))
    return c0, c1


@_named_plan
def fp12_mul_by_045_plan():
    """Sparse line multiply: 12 f rows + 6 line rows (g0, g4, g5) -> 12."""
    g0, g4, g5 = (inp(12), inp(13)), (inp(14), inp(15)), (inp(16), inp(17))
    return _flatten12(
        *_f12_mul_by_045_sym(_f6_in(0), _f6_in(6), g0, g4, g5)
    )


@_named_plan
def fp12_sqr_mul_by_045_plan():
    """The fused Miller doubling-step update f^2 * line: 12 f rows + 6
    line rows -> 12."""
    g0, g4, g5 = (inp(12), inp(13)), (inp(14), inp(15)), (inp(16), inp(17))
    s0, s1 = _f12_sqr_sym(_f6_in(0), _f6_in(6))
    return _flatten12(*_f12_mul_by_045_sym(s0, s1, g0, g4, g5))


def _f12_cyclo_sqr_sym(blocks):
    """One Granger-Scott cyclotomic squaring (ePrint 2009/565) over six
    symbolic Fp2 blocks (a0, a1, a2, b0, b1, b2)."""
    a0, a1, a2, b0, b1, b2 = blocks

    def fp4_sqr(x, y):
        """t0 = x^2 + xi y^2, t1 = (x+y)^2 - x^2 - y^2."""
        x2, y2 = f2_sqr(x), f2_sqr(y)
        s2 = f2_sqr(f2_add(x, y))
        t0 = f2_add(f2_mul_by_xi(y2), x2)
        t1 = f2_sub(f2_sub(s2, x2), y2)
        return t0, t1

    t00, t01 = fp4_sqr(a0, b1)
    t10, t11 = fp4_sqr(b0, a2)
    t20, t21 = fp4_sqr(a1, b2)
    xt21 = f2_mul_by_xi(t21)

    def out3m2(t, z):
        """3t - 2z = 2(t - z) + t."""
        u = f2_sub(t, z)
        return f2_add(f2_add(u, u), t)

    def out3p2(t, z):
        """3t + 2z = 2(t + z) + t."""
        u = f2_add(t, z)
        return f2_add(f2_add(u, u), t)

    return (
        out3m2(t00, a0),
        out3m2(t10, a1),
        out3m2(t20, a2),
        out3p2(xt21, b0),
        out3p2(t01, b1),
        out3p2(t11, b2),
    )


@_named_plan
def fp12_cyclotomic_sqr_plan():
    """Granger-Scott cyclotomic squaring: 12 input rows -> 12."""
    return fp12_cyclotomic_sqr_k_plan(1)


@_named_plan
def fp12_cyclotomic_sqr_k_plan(k: int):
    """k chained cyclotomic squarings in one launch: 12 input rows -> 12."""
    blocks = tuple((inp(2 * i), inp(2 * i + 1)) for i in range(6))
    for _ in range(k):
        blocks = _f12_cyclo_sqr_sym(blocks)
    return tuple(n for f2 in blocks for n in f2)


@_named_plan
def g2_dbl_step_plan():
    """prepare_g2 doubling step: tangent-line coefficients (a = xi 2YZ^2,
    b = 3X^3 - 2Y^2 Z, c = -3X^2 Z) and the RCB Algorithm-9 point doubling,
    sharing the Y^2 / YZ products.  Inputs X, Y, Z (6 rows) -> a, b, c,
    X3, Y3, Z3."""
    X, Y, Z = (inp(0), inp(1)), (inp(2), inp(3)), (inp(4), inp(5))
    xx, yy, zz = f2_sqr(X), f2_sqr(Y), f2_sqr(Z)
    yz, xy = f2_mul(Y, Z), f2_mul(X, Y)
    xxx, yyz = f2_mul(xx, X), f2_mul(yy, Z)
    yzz, xxz = f2_mul(yz, Z), f2_mul(xx, Z)
    la = f2_mul_by_xi(f2_dbl(yzz))
    lb = f2_sub(f2_add(f2_dbl(xxx), xxx), f2_dbl(yyz))
    lc = f2_neg(f2_add(f2_dbl(xxz), xxz))
    # RCB Alg 9 (a = 0): t0 = Y^2, t1 = YZ shared with the line
    t0, t1 = yy, yz
    t2 = f2_mul_b3(zz)
    z3t = f2_dbl(f2_dbl(f2_dbl(t0)))          # 8 Y^2
    y3s = f2_add(t0, t2)
    t0d = f2_sub(t0, f2_add(f2_dbl(t2), t2))  # t0 - 3 t2
    x3 = f2_dbl(f2_mul(t0d, xy))
    y3 = f2_add(f2_mul(t2, z3t), f2_mul(t0d, y3s))
    z3 = f2_mul(t1, z3t)
    return _flatten_f2s((la, lb, lc, x3, y3, z3))


@_named_plan
def g2_add_step_plan():
    """prepare_g2 addition step: chord-line coefficients (D = X - xq Z,
    N = Y - yq Z; a = xi D, b = N xq - yq D, c = -N) and the RCB
    Algorithm-8 mixed addition, sharing the xq Z / yq Z products.  Inputs
    X, Y, Z, xq, yq (10 rows) -> a, b, c, X3, Y3, Z3."""
    X, Y, Z = (inp(0), inp(1)), (inp(2), inp(3)), (inp(4), inp(5))
    xq, yq = (inp(6), inp(7)), (inp(8), inp(9))
    xqz, yqz = f2_mul(xq, Z), f2_mul(yq, Z)
    d = f2_sub(X, xqz)
    n = f2_sub(Y, yqz)
    la = f2_mul_by_xi(d)
    lb = f2_sub(f2_mul(n, xq), f2_mul(yq, d))
    lc = f2_neg(n)
    # RCB Alg 8 (a = 0, z2 = 1)
    t0, t1 = f2_mul(X, xq), f2_mul(Y, yq)
    t3 = f2_sub(f2_mul(f2_add(xq, yq), f2_add(X, Y)), f2_add(t0, t1))
    t4 = f2_add(yqz, Y)
    y3m = f2_add(xqz, X)
    t0_3 = f2_add(f2_dbl(t0), t0)
    t2 = f2_mul_b3(Z)
    z3s = f2_add(t1, t2)
    t1d = f2_sub(t1, t2)
    y3b = f2_mul_b3(y3m)
    pa = f2_mul(t4, y3b)
    pb = f2_mul(t3, t1d)
    pc = f2_mul(y3b, t0_3)
    pd = f2_mul(t1d, z3s)
    pe = f2_mul(t0_3, t3)
    pg = f2_mul(z3s, t4)
    x3 = f2_sub(pb, pa)
    y3 = f2_add(pd, pc)
    z3 = f2_add(pg, pe)
    return _flatten_f2s((la, lb, lc, x3, y3, z3))


MAIN_PATH_PLANS = (
    fp12_sqr_mul_by_045_plan, fp12_mul_by_045_plan, g2_dbl_step_plan,
    g2_add_step_plan, functools.partial(fp12_cyclotomic_sqr_k_plan, 4),
    fp12_cyclotomic_sqr_plan, fp12_mul_plan, fp12_sqr_plan,
)


# ---------------------------------------------------------------------------
# Group-law plans: the Renes-Costello-Batina complete formulas (ePrint
# 2015/1060 Algorithms 7, 8, 9 with a = 0), one launch per group operation
# (g1.rs:638/670/715 algebra; the JAX package's plans, plan_exec.py:451-594)
# ---------------------------------------------------------------------------


def fp_mul_b3(a: Node) -> Node:
    """12 * a by additions (3 b with b = 4 on G1; g1.rs:596 trick)."""
    d2 = add(a, a)
    d4 = add(d2, d2)
    d8 = add(d4, d4)
    return add(d8, d4)


@_named_plan
def g1_add_plan():
    """RCB Algorithm 7 over Fp: rows (X1 Y1 Z1 X2 Y2 Z2) -> (X3 Y3 Z3).
    Stage-2 cross products fuse pairwise into 3 two-term sops."""
    x1, y1, z1, x2, y2, z2 = [inp(i) for i in range(6)]
    t0 = sop([(x1, x2)])
    t1 = sop([(y1, y2)])
    t2 = sop([(z1, z2)])
    m3 = sop([(add(x1, y1), add(x2, y2))])
    m4 = sop([(add(y1, z1), add(y2, z2))])
    m5 = sop([(add(x1, z1), add(x2, z2))])
    t3 = sub(m3, add(t0, t1))
    t4 = sub(m4, add(t1, t2))
    y3 = sub(m5, add(t0, t2))
    t0_3 = add(add(t0, t0), t0)
    t2b = fp_mul_b3(t2)
    z3 = add(t1, t2b)
    t1d = sub(t1, t2b)
    y3b = fp_mul_b3(y3)
    x3 = sop([(t3, t1d), (neg(t4), y3b)])
    y3o = sop([(t1d, z3), (y3b, t0_3)])
    z3o = sop([(z3, t4), (t0_3, t3)])
    return (x3, y3o, z3o)


@_named_plan
def g1_double_plan():
    """RCB Algorithm 9 over Fp: rows (X Y Z) -> (X3 Y3 Z3)."""
    x, y, z = inp(0), inp(1), inp(2)
    t0 = sop([(y, y)])
    t1 = sop([(y, z)])
    zz = sop([(z, z)])
    xy = sop([(x, y)])
    t2 = fp_mul_b3(zz)
    z3t = add(add(t0, t0), add(t0, t0))
    z3t = add(z3t, z3t)                        # 8 Y^2
    y3s = add(t0, t2)
    t0d = sub(t0, add(add(t2, t2), t2))        # t0 - 3 t2
    xym = sop([(t0d, xy)])
    x3 = add(xym, xym)
    y3 = sop([(t2, z3t), (t0d, y3s)])
    z3 = sop([(t1, z3t)])
    return (x3, y3, z3)


@_named_plan
def g1_add_mixed_plan():
    """RCB Algorithm 8 (Z2 = 1) over Fp: rows (X1 Y1 Z1 X2 Y2) ->
    (X3 Y3 Z3).  The affine-identity select stays outside the kernel."""
    x1, y1, z1, x2, y2 = [inp(i) for i in range(5)]
    t0 = sop([(x1, x2)])
    t1 = sop([(y1, y2)])
    m3 = sop([(add(x2, y2), add(x1, y1))])
    xz = sop([(x2, z1)])
    yz = sop([(y2, z1)])
    t3 = sub(m3, add(t0, t1))
    t4 = add(yz, y1)
    y3m = add(xz, x1)
    t0_3 = add(add(t0, t0), t0)
    t2 = fp_mul_b3(z1)
    z3 = add(t1, t2)
    t1d = sub(t1, t2)
    y3b = fp_mul_b3(y3m)
    x3 = sop([(t3, t1d), (neg(t4), y3b)])
    y3o = sop([(t1d, z3), (y3b, t0_3)])
    z3o = sop([(z3, t4), (t0_3, t3)])
    return (x3, y3o, z3o)


@_named_plan
def g2_add_plan():
    """RCB Algorithm 7 over Fp2: rows (X1 Y1 Z1 X2 Y2 Z2 as c0, c1 pairs;
    12 rows) -> 6 rows."""
    x1, y1, z1 = (inp(0), inp(1)), (inp(2), inp(3)), (inp(4), inp(5))
    x2, y2, z2 = (inp(6), inp(7)), (inp(8), inp(9)), (inp(10), inp(11))
    t0 = f2_mul(x1, x2)
    t1 = f2_mul(y1, y2)
    t2 = f2_mul(z1, z2)
    m3 = f2_mul(f2_add(x1, y1), f2_add(x2, y2))
    m4 = f2_mul(f2_add(y1, z1), f2_add(y2, z2))
    m5 = f2_mul(f2_add(x1, z1), f2_add(x2, z2))
    t3 = f2_sub(m3, f2_add(t0, t1))
    t4 = f2_sub(m4, f2_add(t1, t2))
    y3 = f2_sub(m5, f2_add(t0, t2))
    t0_3 = f2_add(f2_dbl(t0), t0)
    t2b = f2_mul_b3(t2)
    z3 = f2_add(t1, t2b)
    t1d = f2_sub(t1, t2b)
    y3b = f2_mul_b3(y3)
    x3 = f2_sop([(t3, t1d, False), (f2_neg(t4), y3b, False)])
    y3o = f2_sop([(t1d, z3, False), (y3b, t0_3, False)])
    z3o = f2_sop([(z3, t4, False), (t0_3, t3, False)])
    return _flatten_f2s((x3, y3o, z3o))


@_named_plan
def g2_double_plan():
    """RCB Algorithm 9 over Fp2: 6 rows -> 6 rows."""
    x, y, z = (inp(0), inp(1)), (inp(2), inp(3)), (inp(4), inp(5))
    t0 = f2_sqr(y)
    t1 = f2_mul(y, z)
    zz = f2_sqr(z)
    xy = f2_mul(x, y)
    t2 = f2_mul_b3(zz)
    z3t = f2_dbl(f2_dbl(f2_dbl(t0)))           # 8 Y^2
    y3s = f2_add(t0, t2)
    t0d = f2_sub(t0, f2_add(f2_dbl(t2), t2))   # t0 - 3 t2
    x3 = f2_dbl(f2_mul(t0d, xy))
    y3 = f2_sop([(t2, z3t, False), (t0d, y3s, False)])
    z3 = f2_mul(t1, z3t)
    return _flatten_f2s((x3, y3, z3))


@_named_plan
def g2_add_mixed_plan():
    """RCB Algorithm 8 (Z2 = 1) over Fp2: rows (X1 Y1 Z1 X2 Y2; 10 rows)
    -> 6 rows."""
    x1, y1, z1 = (inp(0), inp(1)), (inp(2), inp(3)), (inp(4), inp(5))
    x2, y2 = (inp(6), inp(7)), (inp(8), inp(9))
    t0 = f2_mul(x1, x2)
    t1 = f2_mul(y1, y2)
    m3 = f2_mul(f2_add(x2, y2), f2_add(x1, y1))
    xz = f2_mul(x2, z1)
    yz = f2_mul(y2, z1)
    t3 = f2_sub(m3, f2_add(t0, t1))
    t4 = f2_add(yz, y1)
    y3m = f2_add(xz, x1)
    t0_3 = f2_add(f2_dbl(t0), t0)
    t2 = f2_mul_b3(z1)
    z3 = f2_add(t1, t2)
    t1d = f2_sub(t1, t2)
    y3b = f2_mul_b3(y3m)
    x3 = f2_sop([(t3, t1d, False), (f2_neg(t4), y3b, False)])
    y3o = f2_sop([(t1d, z3, False), (y3b, t0_3, False)])
    z3o = f2_sop([(z3, t4, False), (t0_3, t3, False)])
    return _flatten_f2s((x3, y3o, z3o))


GROUP_LAW_PLANS = (g1_add_plan, g1_double_plan, g1_add_mixed_plan,
                   g2_add_plan, g2_double_plan, g2_add_mixed_plan)


def _sources(n: Node) -> tuple:
    """The nodes a node reads, in its row's order (a sop's pairs flat)."""
    if n.op == "sop":
        return tuple(x for pair in n.args for x in pair)
    return n.args


def _depths(outputs) -> dict:
    """Depth of every node the outputs reach, in post-order: 0 for inputs,
    else one more than its deepest source (so every depth up to the
    largest holds a node)."""
    depth = {}

    def visit(n):
        d = depth.get(n)
        if d is None:
            d = depth[n] = 0 if n.op == "in" else \
                1 + max(visit(x) for x in _sources(n))
        return d

    for o in outputs:
        visit(o)
    return depth


def _plan_schedule(outputs):
    """Level-batched schedule: nodes sharing (depth, op, T) are mutually
    independent; returns the groups in dependency order."""
    groups = {}
    for n, d in _depths(outputs).items():
        if n.op != "in":
            key = (d, n.op, len(n.args) if n.op == "sop" else 0)
            groups.setdefault(key, []).append(n)
    return [groups[k] for k in sorted(groups)]


# ---------------------------------------------------------------------------
# Compiled instruction tables
# ---------------------------------------------------------------------------


def slot_words(lt: int) -> int:
    """32-bit words of one slot in a block of lt lanes ([word][lane]).  Under
    a warp's width one padding word per lane makes the slot stride 13 lt,
    an odd multiple of lt: the 32 / lt nodes a warp covers then read one
    word from distinct banks whenever their slots differ mod 32 / lt (the
    lowest-free allocation makes that the common case).  From lt = 32 a
    warp is 32 lanes of one node, conflict-free unpadded."""
    return lt * (WORDS + (lt < 32))


class _Tables(NamedTuple):
    program: torch.Tensor     # uint8: the kernel's byte program
    load_rows: torch.Tensor   # int64: operand rows loaded ...
    load_slots: torch.Tensor  # ... into these slots
    out_slots: torch.Tensor   # int64
    phases: list              # per phase: (op, dst, src_a, src_b) per group


@dataclasses.dataclass(eq=False)
class CompiledPlan:
    """A plan as an instruction table in level-group order, cut into
    phases (the groups of one depth), with slots reused by liveness."""

    name: str
    n_in: int              # operand rows the plan takes
    n_slots: int           # value slots: the plan's peak live count
    instr: np.ndarray      # [n_rows, INSTR_WIDTH] int32: op, dst, T, srcs
    groups: tuple          # ((start, stop), ...) row ranges of level groups
    phases: tuple          # ((start, stop), ...) row ranges of depths
    loads: np.ndarray      # [n_loads, 2] int32: (operand row, slot)
    out_slots: np.ndarray  # [n_out] int32
    fold: bool = False     # output o written into input o's slot
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_out(self) -> int:
        return len(self.out_slots)

    def sop_terms(self) -> list[int]:
        """Term count of every sop row (the multiply work of one lane)."""
        rows = self.instr[self.instr[:, 0] == OP_CODES["sop"]]
        return [int(t) for t in rows[:, 2]]

    @functools.cached_property
    def program(self) -> np.ndarray:
        """The kernel's byte program (`_encode_program`)."""
        return _encode_program(self)

    def smem_bytes(self, lt: int, fold: bool = False) -> int:
        """Shared memory of a block of lt lanes: the program, staged once
        per block, then the slot array; in fold mode then, from the next 8
        bytes, FOLDER_BYTES a lane."""
        words = self.n_slots * slot_words(lt)
        if fold:
            return len(self.program) + 4 * (words + words % 2) \
                + FOLDER_BYTES * lt
        return len(self.program) + 4 * words

    def launch_shape(self, B: int, n_sm: int = SM_COUNT, fold: bool = False):
        """(lane tile Lt, threads, shared-memory bytes) of a launch over B
        lanes (fold mode: B folders).  Lt is the largest power of two <=
        MAX_LANE_TILE that still gives at least half of the n_sm SMs a
        block and keeps the block's shared memory within SMEM_BUDGET; one
        lane where nothing wider does.  (On the H100 a narrow batch is
        latency-bound, so 128 tiles of 8 lanes beat 256 of 4 at B = 1024;
        a wide one is bound by resident threads, which 64-lane tiles of 192
        threads maximise.)"""
        lt = MAX_LANE_TILE
        while lt > 1 and (-(-B // lt) < n_sm // 2
                          or self.smem_bytes(lt, fold) > SMEM_BUDGET):
            lt //= 2
        return lt, THREADS, self.smem_bytes(lt, fold)

    def tables(self, device: torch.device) -> _Tables:
        """The tables on a device, made once."""
        t = self._tables.get(device)
        if t is None:
            def idx(a):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.int64, device=device)

            phases = [[(int(self.instr[s, 0]),
                        *(idx(c) for c in _group_columns(self.instr[s:e])))
                       for s, e in self.groups if p0 <= s < p1]
                      for p0, p1 in self.phases]
            t = self._tables[device] = _Tables(
                program=torch.as_tensor(self.program, device=device),
                load_rows=idx(self.loads[:, 0]),
                load_slots=idx(self.loads[:, 1]),
                out_slots=idx(self.out_slots), phases=phases)
        return t


def _group_columns(rows: np.ndarray):
    """dst and source slot columns of one level group's rows."""
    op, n_terms = rows[0, 0], rows[0, 2]
    if op == OP_CODES["sop"]:
        return (rows[:, 1], rows[:, 3:3 + 2 * n_terms:2],
                rows[:, 4:4 + 2 * n_terms:2])
    return (rows[:, 1], rows[:, 3], rows[:, 4])


def n_sources(op: int, n_terms: int) -> int:
    """Source slots of a row."""
    if op == OP_CODES["sop"]:
        return 2 * n_terms
    return 1 if op == OP_CODES["neg"] else 2


def _encode_program(plan: CompiledPlan) -> np.ndarray:
    """The table as the kernel reads it (`csrc/plan_exec.cu`), little-endian
    bytes, each section starting at a multiple of 4 and the whole padded
    to 16 (the kernel stages it with 16-byte loads):
      header   u16[8]   n_phases, n_loads, n_out, n_slots, then the byte
                        offsets of the four sections below
      phases   u16[n_phases + 1]   first row of each phase, then n_rows
      rows_at  u16[n_rows]         word offset of each row in `rows`
      io       u8[2 n_loads + n_out]   (operand row, slot) of each load,
                        then the output slots
      rows     per row [op | T << 4, dst, src...] as bytes, padded to 4
                        (T = 0 for add / sub / neg; neg has one source)."""
    rows, rows_at = bytearray(), []
    for r in plan.instr:
        op, dst, t = (int(x) for x in r[:3])
        rows_at.append(len(rows) // 4)
        row = bytes([op | t << 4, dst, *(int(x) for x in
                                         r[3:3 + n_sources(op, t)])])
        rows += row + bytes(-len(row) % 4)
    sections = (
        np.array([s for s, _ in plan.phases] + [len(plan.instr)], "<u2"),
        np.array(rows_at, "<u2"),
        np.concatenate([plan.loads.reshape(-1), plan.out_slots])
        .astype(np.uint8),
        np.frombuffer(bytes(rows), np.uint8),
    )
    body, offsets = bytearray(16), []
    for sec in sections:
        offsets.append(len(body))
        raw = sec.tobytes()
        body += raw + bytes(-len(raw) % 4)
    body += bytes(-len(body) % 16)
    if len(body) >= 1 << 16:
        raise ValueError(f"plan {plan.name}: program of {len(body)} bytes "
                         "(16-bit offsets)")
    body[:16] = np.array([len(plan.phases), len(plan.loads), plan.n_out,
                          plan.n_slots, *offsets], "<u2").tobytes()
    return np.frombuffer(bytes(body), np.uint8).copy()


_COMPILED: dict = {}


def compile_plan(outputs, fold: bool = False) -> CompiledPlan:
    """The plan's table, built once per plan: rows in level-group order, the
    phase boundaries where the depth changes, and slots by liveness.  A
    value holds its slot from its phase to the phase of its last read
    (outputs, inputs among them, to the end); the slot then goes back to a
    free list, from which the lowest is taken by the next node of a LATER
    phase that needs one, so no slot is written in the phase that reads
    it.  Greedy in phase order, this uses the peak live count of slots.

    fold=True compiles the plan for the kernel's fold mode: output o is
    written into the slot of input row o (an accumulator that the next
    evaluation reads in place), so those slots are held for the outputs,
    each free from the phase after its input's last read."""
    outputs = tuple(outputs)
    plan = _COMPILED.get((outputs, fold))
    if plan is not None:
        return plan
    depth = _depths(outputs)
    schedule = _plan_schedule(outputs)
    last = {}
    for group in schedule:
        for n in group:
            for x in _sources(n):
                last[x] = max(last.get(x, 0), depth[n])
    last.update((o, 1 + max(depth.values())) for o in outputs)
    inputs = sorted((x for x in last if x.op == "in"),
                    key=lambda x: x.args[0])
    free, slot, freed_after = [], {}, collections.defaultdict(list)
    n_slots = 0
    # fold: output o -> its input's node, whose slot it takes
    pinned = {o: inp(k) for k, o in enumerate(outputs)} if fold else {}
    if any(o.op == "in" or pinned[o] not in last
           or last[pinned[o]] >= depth[o] for o in pinned):
        raise ValueError("a fold plan's output o must be a new value made "
                         "after the last read of input row o")

    def take(v):
        nonlocal n_slots
        if v in pinned:
            slot[v] = slot[pinned[v]]
            return
        if free:
            slot[v] = heapq.heappop(free)
        else:
            slot[v], n_slots = n_slots, n_slots + 1
        if not (fold and v.op == "in" and v.args[0] < len(outputs)):
            freed_after[last[v]].append(slot[v])

    for x in inputs:
        take(x)
    rows, groups, starts, phase_depth = [], [], [], 0
    for group in schedule:
        d = depth[group[0]]
        if d != phase_depth:
            # a new phase (depths are consecutive): what phase d - 1 read
            # last is free now
            for s in freed_after.pop(d - 1, ()):
                heapq.heappush(free, s)
            starts.append(len(rows))
            phase_depth = d
        start = len(rows)
        for n in group:
            srcs = [slot[x] for x in _sources(n)]
            take(n)
            row = np.zeros(INSTR_WIDTH, np.int32)
            row[0], row[1] = OP_CODES[n.op], slot[n]
            if n.op == "sop":
                if len(n.args) > MAX_TERMS:
                    raise ValueError(f"sop node of {len(n.args)} terms; the "
                                     f"kernel takes at most {MAX_TERMS}")
                row[2] = len(n.args)
            row[3:3 + len(srcs)] = srcs
            rows.append(row)
        groups.append((start, len(rows)))
    n_in = 1 + max(x.args[0] for x in inputs)
    if n_slots > MAX_SLOTS or n_in > MAX_SLOTS:
        raise ValueError(f"plan of {n_slots} slots and {n_in} operand rows; "
                         f"the kernel's 8-bit indices take {MAX_SLOTS}")
    plan = _COMPILED[(outputs, fold)] = CompiledPlan(
        name=_PLAN_NAMES.get(outputs, f"plan[{len(rows)} nodes]")
        + ("[fold]" if fold else ""),
        n_in=n_in,
        n_slots=n_slots,
        instr=np.stack(rows) if rows else np.zeros((0, INSTR_WIDTH), np.int32),
        groups=tuple(groups),
        phases=tuple(zip(starts, starts[1:] + [len(rows)])),
        loads=np.array([(x.args[0], slot[x]) for x in inputs],
                       np.int32).reshape(-1, 2),
        out_slots=np.array([slot[o] for o in outputs], np.int32),
        fold=fold,
    )
    return plan


# ---------------------------------------------------------------------------
# Plain version and wrapper
# ---------------------------------------------------------------------------


def _eval_group(vals: torch.Tensor, op: int, src_a, src_b) -> torch.Tensor:
    """One level group's values [G, L, B] from the slots it reads."""
    if op == OP_CODES["sop"]:
        # [G, T, L, B] -> [T, L, G, B]
        r = sop_plain(vals[src_a].permute(1, 2, 0, 3),
                      vals[src_b].permute(1, 2, 0, 3))
    else:
        x = vals[src_a].transpose(0, 1)  # [L, G, B]
        if op == OP_CODES["neg"]:
            r = limbs.neg(limbs.FP, x)
        else:
            fn = limbs.add if op == OP_CODES["add"] else limbs.sub
            r = fn(limbs.FP, x, vals[src_b].transpose(0, 1))
    return r.transpose(0, 1)


def plan_exec_plain(ops: torch.Tensor, plan: CompiledPlan) -> torch.Tensor:
    """Walk the plan's table with PyTorch, one phase at a time: every level
    group of a phase gathers its sources (one vectorised call per group)
    before any of them writes its destinations, as the kernel's barrier
    orders them.  int32 [K, L, B] -> [O, L, B]."""
    t = plan.tables(ops.device)
    vals = torch.zeros((plan.n_slots, L, ops.shape[2]), dtype=limbs.DTYPE,
                       device=ops.device)
    vals[t.load_slots] = ops[t.load_rows]
    for phase in t.phases:
        results = [(dst, _eval_group(vals, op, a, b))
                   for op, dst, a, b in phase]
        for dst, r in results:
            vals[dst] = r
    return vals[t.out_slots]


_SIGNATURES = {
    # (ops, out, program, program bytes, B, log2 lane tile, threads,
    #  shared bytes, stream)
    "bls_plan_exec": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p),
    # (program, program bytes, &_FoldArgs, runs, log2 folder tile, threads,
    #  shared bytes, stream)
    "bls_plan_fold": (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p),
}


def plan_exec(ops: torch.Tensor, plan: CompiledPlan) -> torch.Tensor:
    """Evaluate a compiled plan over stacked operands: int32 [K, L, B]
    canonical Montgomery limbs -> [O, L, B]."""
    if ops.dtype != limbs.DTYPE or ops.dim() != 3 or ops.shape[1] != L \
            or ops.shape[0] < plan.n_in:
        raise ValueError(f"plan_exec {plan.name}: expected int32 "
                         f"[>={plan.n_in}, {L}, B], got {tuple(ops.shape)} "
                         f"{ops.dtype}")
    if device_kind(ops) == "cpu":
        return plan_exec_plain(ops, plan)
    B = ops.shape[2]
    ops = ops.contiguous()
    out = torch.empty((plan.n_out, L, B), dtype=limbs.DTYPE,
                      device=ops.device)
    if B == 0:
        return out
    lt, threads, smem = plan.launch_shape(B, sm_count(ops.device.index))
    program = plan.tables(ops.device).program
    lib = build.load("plan_exec", _SIGNATURES)
    with torch.cuda.device(ops.device):
        stream = torch.cuda.current_stream(ops.device).cuda_stream
        rc = lib.bls_plan_exec(ops.data_ptr(), out.data_ptr(),
                               program.data_ptr(), program.numel(), B,
                               lt.bit_length() - 1, threads, smem, stream)
        LAUNCHES.plan_exec += 1
        LAUNCHES.plan_exec_by_plan[plan.name] += 1
    check_launch(rc, f"plan_exec {plan.name}")
    return out


# ---------------------------------------------------------------------------
# Fold mode: sums of the runs of equal dest along sorted lanes
# ---------------------------------------------------------------------------


def pack_words(rows) -> torch.Tensor:
    """Fp rows ([L, *batch] limbs, one batch) -> int32 [N, len(rows) * 12]:
    each point's rows as 32-bit words (limb 2k | limb 2k+1 << 16, the bits
    of a uint32), point-major: the fold's operand layout."""
    t = torch.stack([r.reshape(L, -1) for r in rows])
    n = t.shape[-1]
    pairs = t.view(len(rows), WORDS, 2, n).permute(3, 0, 1, 2)
    return pairs.to(torch.int16).contiguous().flatten().view(
        torch.int32).reshape(n, len(rows) * WORDS)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """pack_words' inverse: int32 [N, R * 12] -> limbs [R, L, N]."""
    n = words.shape[0]
    limbs16 = words.contiguous().flatten().view(torch.int16).to(
        limbs.DTYPE) & 0xFFFF
    return limbs16.reshape(n, -1, L).permute(1, 2, 0)


class _FoldArgs(ctypes.Structure):
    """csrc/plan_exec.cu `PlanFoldArgs`, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "src", "order", "negs", "dest", "content", "totals", "part",
        "part_content")] + [(name, ctypes.c_int) for name in (
            "K", "M", "n_totals", "src_words", "neg_lo", "neg_hi")] + [
        ("one_mask", ctypes.c_uint)]


class Fold(NamedTuple):
    """One fold level's operands (`plan_fold`): K sorted lanes, each adding
    the point src[order[i]] (src[i] without an order; int32 [n, rows * 12]
    words, `pack_words`), operand rows [neg_lo, neg_hi) negated where
    negs[i]; the segments are the runs of equal dest[i] (int64,
    non-decreasing); content[i] false marks a lane that holds no piece
    (bool, None: every lane holds one); one_mask: the accumulator rows that
    are 1 in the identity."""
    src: torch.Tensor
    dest: torch.Tensor
    order: torch.Tensor | None = None
    negs: torch.Tensor | None = None
    neg_rows: tuple = (0, 0)
    content: torch.Tensor | None = None
    one_mask: int = 0


def _check_fold(plan: CompiledPlan, fold: Fold, M: int, totals) -> None:
    n_acc = plan.n_out
    if not (plan.fold
            and plan.loads[:, 0].tolist() == list(range(plan.n_in))):
        raise ValueError(f"plan_fold: {plan.name} is not compiled for the "
                         "fold (compile_plan(..., fold=True))")
    K = fold.dest.shape[-1]
    words = (plan.n_in - n_acc) * WORDS
    if fold.src.dtype != limbs.DTYPE or fold.src.dim() != 2 \
            or fold.src.shape[1] != words or fold.dest.dim() != 1 \
            or fold.dest.dtype != torch.int64 or K < 1 or M < 1:
        raise ValueError(f"plan_fold {plan.name}: expected src int32 [n, "
                         f"{words}], dest int64 [K >= 1], M >= 1; got "
                         f"{tuple(fold.src.shape)} {fold.src.dtype}, "
                         f"{tuple(fold.dest.shape)} {fold.dest.dtype}, {M}")
    if totals.dtype != limbs.DTYPE or totals.dim() != 3 \
            or tuple(totals.shape[:2]) != (n_acc, L):
        raise ValueError(f"plan_fold {plan.name}: totals must be int32 "
                         f"[{n_acc}, {L}, n], got {tuple(totals.shape)}")
    for name in ("order", "negs", "content"):
        t = getattr(fold, name)
        if t is not None and tuple(t.shape) != (K,):
            raise ValueError(f"plan_fold {plan.name}: {name} must be [{K}]")
    lo, hi = fold.neg_rows
    if (fold.negs is None) != (hi <= lo) or lo < 0 \
            or hi > plan.n_in - n_acc:
        raise ValueError(f"plan_fold {plan.name}: negated rows {lo}..{hi} "
                         "need negs, and negs rows to negate")


def plan_fold(plan: CompiledPlan, fold: Fold, M: int,
              totals: torch.Tensor):
    """One level of the fold: the K lanes of `fold` in runs of M, one
    folder a run, each adding its lanes' points with `plan` (compiled with
    fold=True) into an accumulator that a segment's first lane resets to
    the identity.  A segment inside one run is written into totals [rows,
    L, n] (16-bit limbs, column dest, in place; only where it held
    content); each run leaves two partials, its first piece where that is
    open on the left and its last where that is open on the right (else
    the identity, without content).  Returns the next level's Fold over
    the partials (src [2 runs, rows * 12]) with the full addition's plan
    still to pick: its lanes are sorted like these.  A segment whose dest
    lies outside [0, n) is summed and dropped."""
    _check_fold(plan, fold, M, totals)
    K = fold.dest.shape[0]
    runs = -(-K // M)
    first = torch.arange(runs, device=fold.dest.device) * M
    ends = torch.clamp(first + M, max=K) - 1
    part_dest = torch.stack([fold.dest[first], fold.dest[ends]], 1)
    if device_kind(fold.dest) == "cpu":
        part, content = plan_fold_plain(plan, fold, M, totals)
    else:
        part, content = _plan_fold_cuda(plan, fold, M, totals, runs)
    return Fold(part, part_dest.reshape(-1), content=content,
                one_mask=fold.one_mask)


def _plan_fold_cuda(plan, fold: Fold, M: int, totals, runs: int):
    K = fold.dest.shape[0]
    dev = fold.dest.device
    part = torch.empty((2 * runs, plan.n_out * WORDS), dtype=limbs.DTYPE,
                       device=dev)
    content = torch.empty(2 * runs, dtype=torch.bool, device=dev)
    held = [t.contiguous() if t is not None else None for t in
            (fold.src, fold.order, fold.negs, fold.dest, fold.content)]
    src, order, negs, dest, cont = held
    if not totals.is_contiguous():
        raise ValueError(f"plan_fold {plan.name}: totals must be contiguous")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    args = _FoldArgs(ptr(src), ptr(order), ptr(negs), ptr(dest), ptr(cont),
                     totals.data_ptr(), part.data_ptr(), content.data_ptr(),
                     K, M, totals.shape[2], src.shape[1], *fold.neg_rows,
                     fold.one_mask)
    lt, threads, smem = plan.launch_shape(runs, sm_count(dev.index),
                                          fold=True)
    program = plan.tables(dev).program
    lib = build.load("plan_exec", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bls_plan_fold(program.data_ptr(), program.numel(),
                               ctypes.byref(args), runs, lt.bit_length() - 1,
                               threads, smem, stream)
        LAUNCHES.plan_exec += 1
        LAUNCHES.plan_exec_by_plan[plan.name] += 1
    check_launch(rc, f"plan_fold {plan.name}")
    return part, content


def plan_fold_plain(plan, fold: Fold, M: int, totals):
    """The kernel's fold mode with PyTorch, every folder at once, one step
    (lane of the run) at a time: the same resets, pieces, partials and
    content flags, each evaluation by `plan_exec_plain`."""
    K = fold.dest.shape[0]
    dest, dev = fold.dest, fold.dest.device
    n_acc = plan.n_out
    runs = -(-K // M)
    g = torch.arange(runs, device=dev)
    base = g * M
    last = torch.clamp(base + M, max=K) - 1
    d0 = dest[base]
    open_left = (base > 0) & (dest[(base - 1).clamp(min=0)] == d0)
    ident = torch.stack([limbs.const(limbs.FP, (fold.one_mask >> r) & 1,
                                     (), device=dev)
                         for r in range(n_acc)])[..., None]
    # the partials start as the identity without content; pieces overwrite
    part = pack_words(list(ident.expand(n_acc, L, 2 * runs))).clone()
    content = torch.zeros(2 * runs, dtype=torch.bool, device=dev)
    acc = ident.expand(n_acc, L, runs)
    open_now, seen, prev = open_left, torch.zeros_like(open_left), d0
    for s in range(M + 1):
        i = base + s
        cur = (i < K) & (s < M)
        ic = i.clamp(max=K - 1)
        d = dest[ic]
        if s == 0:
            reset = torch.ones_like(cur)
        else:
            ends = (i - 1 < K) & (~cur | (d != prev))
            closed_right = cur | (i >= K) | (d != prev)
            emit_first = ends & open_now
            emit_last = ends & ~open_now & ~closed_right
            emit_total = ends & ~open_now & closed_right & seen \
                & (prev >= 0) & (prev < totals.shape[2])
            totals[:, :, prev[emit_total]] = acc[:, :, emit_total]
            for which, mask in ((0, emit_first), (1, emit_last)):
                at = 2 * g[mask] + which
                part[at] = pack_words(list(acc[:, :, mask]))
                content[at] = seen[mask]
            open_now, seen = open_now & ~ends, seen & ~ends
            reset = ends & cur
        if s == M:
            break
        acc = torch.where(reset, ident, acc)
        seen = seen | (cur if fold.content is None
                       else cur & fold.content[ic])
        prev = torch.where(cur, d, prev)
        op = unpack_words(fold.src[fold.order[ic] if fold.order is not None
                                   else ic])
        for r in range(*fold.neg_rows):
            op[r] = torch.where(fold.negs[ic], limbs.neg(limbs.FP, op[r]),
                                op[r])
        acc = plan_exec_plain(torch.cat([acc, op]), plan)
    return part, content


def run_plan(outputs, components):
    """components: the plan's input rows, [L, *batch] Fp tensors in index
    order.  Returns the output rows as a list of [L, *batch] tensors."""
    batch = torch.broadcast_shapes(*[c.shape[1:] for c in components])
    full = (L,) + batch
    ops = torch.stack([c.expand(full) for c in components]).reshape(
        len(components), L, -1)
    out = plan_exec(ops, compile_plan(outputs))
    return [o.reshape(full) for o in out.unbind(0)]
