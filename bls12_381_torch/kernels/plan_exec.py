"""Expression plans: a whole tower operation as one static Fp DAG, one launch.

`plan_exec` replaces `bls12_381_tpu/kernels/plan_exec.py::plan_exec_pallas`
(default body `_plan_kernel`, the level-batched evaluator run by
`run_plan(variant="vector")`).  Source: `csrc/plan_exec.cu` on
`csrc/fp384.cuh`.

The DAG and the plan constructors are the JAX package's, copied: nodes are
`in`, `add`, `sub`, `neg` and `sop` (T <= 6 per node; the constructors chunk
longer sums), interned so that structurally equal nodes are one object.

Design.  `compile_plan` turns a plan into an int32 instruction table once
(cached per plan, uploaded once per device).  Each row is
[op, dst slot, n_terms, src slots...]; rows are ordered by `_plan_schedule`'s
level groups (nodes of one depth, op and term count are independent).  The
CUDA kernel is a generic interpreter: one thread per batch lane walks the
table in the same order as every other thread, so there is no divergence;
each node's value is 12 32-bit words in a per-lane slot of a [slot, 12, B]
scratch tensor; a `sop` row runs the shared Montgomery sum-of-products device
code of `csrc/fp384.cuh`, `add`/`sub`/`neg` are canonical 12-word modular
ripples (the counterparts of `_mod_add_rows`/`_mod_sub_rows`).  The plain
version executes the SAME table, one vectorised PyTorch call per level
group, so the CPU tests cover the table's encoding and only the CUDA
arithmetic is left for the card.

Bound on the card.  Per lane a plan reads K and writes O values (96 bytes
each as int32 limbs) and does ~2 ((T + 1) 144 + 12) 32-bit multiplies per
T-term sop node, so on paper every plan is bound by its multiplies.  The
kernel is far from that: one thread per lane gives a batch of 1024 only 32
warps on the card's 132 SMs, and every node round-trips its 48 bytes
through device memory (L2 at this size).  Spreading a level's independent
nodes across threads, reusing slots by liveness and keeping slots in shared
memory are left to a later change.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import limbs
from . import LAUNCHES, build
from .mont import check_launch, device_kind, sop_plain

L = limbs.FP.n_limbs
WORDS = 12            # 32-bit words per Fp value in the kernel's scratch
MAX_TERMS = 8         # the kernel's sop bound (T p < R)
INSTR_WIDTH = 3 + 2 * MAX_TERMS
OP_CODES = {"add": 1, "sub": 2, "neg": 3, "sop": 4}


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


def _plan_schedule(outputs):
    """Level-batched schedule: nodes sharing (depth, op, T) are mutually
    independent; returns the groups in dependency order."""
    depth = {}

    def visit(n):
        d = depth.get(n)
        if d is not None:
            return d
        if n.op == "in":
            d = 0
        elif n.op == "sop":
            d = 1 + max(max(visit(a), visit(b)) for a, b in n.args)
        else:
            d = 1 + max(visit(c) for c in n.args)
        depth[n] = d
        return d

    for o in outputs:
        visit(o)
    groups = {}
    for n, d in depth.items():
        if n.op == "in":
            continue
        key = (d, n.op, len(n.args) if n.op == "sop" else 0)
        groups.setdefault(key, []).append(n)
    return [groups[k] for k in sorted(groups)]


# ---------------------------------------------------------------------------
# Compiled instruction tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class CompiledPlan:
    """A plan as an int32 instruction table in level-group order."""

    name: str
    n_in: int
    n_slots: int
    instr: np.ndarray      # [n_instr, INSTR_WIDTH] int32
    groups: tuple          # ((start, stop), ...) row ranges of level groups
    out_slots: np.ndarray  # [n_out] int32
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_out(self) -> int:
        return len(self.out_slots)

    def sop_terms(self) -> list[int]:
        """Term count of every sop row (the multiply work of one lane)."""
        rows = self.instr[self.instr[:, 0] == OP_CODES["sop"]]
        return [int(t) for t in rows[:, 2]]

    def tables(self, device: torch.device):
        """(instr, out_slots, group index tensors) on a device, made once."""
        t = self._tables.get(device)
        if t is None:
            def idx(a):
                return torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.int64, device=device)

            t = self._tables[device] = (
                torch.as_tensor(self.instr, device=device),
                torch.as_tensor(self.out_slots, device=device),
                [tuple(idx(c) for c in _group_columns(self.instr[s:e]))
                 for s, e in self.groups],
            )
        return t


def _group_columns(rows: np.ndarray):
    """dst and source slot columns of one level group's rows."""
    op, n_terms = rows[0, 0], rows[0, 2]
    if op == OP_CODES["sop"]:
        return (rows[:, 1], rows[:, 3:3 + 2 * n_terms:2],
                rows[:, 4:4 + 2 * n_terms:2])
    return (rows[:, 1], rows[:, 3], rows[:, 4])


_COMPILED: dict = {}


def compile_plan(outputs) -> CompiledPlan:
    """The plan's instruction table, built once per plan."""
    outputs = tuple(outputs)
    plan = _COMPILED.get(outputs)
    if plan is not None:
        return plan
    schedule = _plan_schedule(outputs)
    in_nodes = {o for o in outputs if o.op == "in"}
    for group in schedule:
        for n in group:
            srcs = (x for pair in n.args for x in pair) if n.op == "sop" \
                else n.args
            in_nodes.update(x for x in srcs if x.op == "in")
    n_in = 1 + max(n.args[0] for n in in_nodes)
    slot = {n: n.args[0] for n in in_nodes}
    rows, groups = [], []
    for group in schedule:
        start = len(rows)
        for n in group:
            slot[n] = n_in + len(rows)
            row = np.zeros(INSTR_WIDTH, np.int32)
            row[0], row[1] = OP_CODES[n.op], slot[n]
            if n.op == "sop":
                if len(n.args) > MAX_TERMS:
                    raise ValueError(f"sop node of {len(n.args)} terms; the "
                                     f"kernel takes at most {MAX_TERMS}")
                row[2] = len(n.args)
                srcs = [slot[x] for pair in n.args for x in pair]
            else:
                srcs = [slot[x] for x in n.args]
            row[3:3 + len(srcs)] = srcs
            rows.append(row)
        groups.append((start, len(rows)))
    plan = _COMPILED[outputs] = CompiledPlan(
        name=_PLAN_NAMES.get(outputs, f"plan[{len(rows)} nodes]"),
        n_in=n_in,
        n_slots=n_in + len(rows),
        instr=np.stack(rows) if rows else np.zeros((0, INSTR_WIDTH), np.int32),
        groups=tuple(groups),
        out_slots=np.array([slot[o] for o in outputs], np.int32),
    )
    return plan


# ---------------------------------------------------------------------------
# Plain version and wrapper
# ---------------------------------------------------------------------------


def plan_exec_plain(ops: torch.Tensor, plan: CompiledPlan) -> torch.Tensor:
    """Walk the plan's instruction table with PyTorch: one vectorised call
    per level group over all of its rows.  int32 [K, L, B] -> [O, L, B]."""
    _, _, groups = plan.tables(ops.device)
    B = ops.shape[2]
    vals = torch.empty((plan.n_slots, L, B), dtype=limbs.DTYPE,
                       device=ops.device)
    vals[:plan.n_in] = ops[:plan.n_in]
    for (start, _), (dst, src_a, src_b) in zip(plan.groups, groups):
        op = int(plan.instr[start, 0])
        if op == OP_CODES["sop"]:
            # [G, T, L, B] -> [T, L, G, B]
            a = vals[src_a].permute(1, 2, 0, 3)
            b = vals[src_b].permute(1, 2, 0, 3)
            r = sop_plain(a, b)
        else:
            x = vals[src_a].transpose(0, 1)  # [L, G, B]
            if op == OP_CODES["neg"]:
                r = limbs.neg(limbs.FP, x)
            else:
                y = vals[src_b].transpose(0, 1)
                fn = limbs.add if op == OP_CODES["add"] else limbs.sub
                r = fn(limbs.FP, x, y)
        vals[dst] = r.transpose(0, 1)
    _, out_slots, _ = plan.tables(ops.device)
    return vals[out_slots.long()]


_SIGNATURES = {
    # (ops, out, scratch, instr, n_instr, out_slots, n_in, n_out, B,
    #  instr_width, stream)
    "bls_plan_exec": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
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
    instr, out_slots, _ = plan.tables(ops.device)
    scratch = torch.empty((plan.n_slots, WORDS, B), dtype=torch.int32,
                          device=ops.device)
    lib = build.load("plan_exec", _SIGNATURES)
    with torch.cuda.device(ops.device):
        stream = torch.cuda.current_stream(ops.device).cuda_stream
        rc = lib.bls_plan_exec(
            ops.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            instr.data_ptr(), len(plan.instr), out_slots.data_ptr(),
            plan.n_in, plan.n_out, B, INSTR_WIDTH, stream)
        LAUNCHES.plan_exec += 1
        LAUNCHES.plan_exec_by_plan[plan.name] += 1
    check_launch(rc, f"plan_exec {plan.name}")
    return out


def run_plan(outputs, components):
    """components: the plan's input rows, [L, *batch] Fp tensors in index
    order.  Returns the output rows as a list of [L, *batch] tensors."""
    batch = torch.broadcast_shapes(*[c.shape[1:] for c in components])
    full = (L,) + batch
    ops = torch.stack([c.expand(full) for c in components]).reshape(
        len(components), L, -1)
    out = plan_exec(ops, compile_plan(outputs))
    return [o.reshape(full) for o in out.unbind(0)]
