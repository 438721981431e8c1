"""The port's expression plans (bls12_381_torch.kernels.plan_exec) against
the JAX package's plans.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of integers or 16-bit limbs.  Each main-path plan is built by the port,
compiled to its instruction table and run by the table's plain executor;
the JAX package's own plan of the same name is evaluated lane by lane with
its pure-Python oracle `eval_plan_host`.  Inputs come from a seeded
generator plus the edge values 0, 1 and p-1.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from bls12_381_tpu.fields import fp as jfp
from bls12_381_tpu.kernels import plan_exec as jpe

from bls12_381_torch import convert
from bls12_381_torch.fields import fp
from bls12_381_torch.kernels import plan_exec as pe
from bls12_381_torch.params import P

torch.set_num_threads(1)
R = 1 << 384
rng = random.Random(4321)

# (constructor name, arguments): the eight plans of the pairing's main path
MAIN_PATH = [
    ("fp12_sqr_mul_by_045_plan", ()),
    ("fp12_mul_by_045_plan", ()),
    ("g2_dbl_step_plan", ()),
    ("g2_add_step_plan", ()),
    ("fp12_cyclotomic_sqr_k_plan", (4,)),
    ("fp12_cyclotomic_sqr_plan", ()),
    ("fp12_mul_plan", ()),
    ("fp12_sqr_plan", ()),
]


def test_main_path_plans_listed_in_order():
    names = [pe.compile_plan(b()).name for b in pe.MAIN_PATH_PLANS]
    assert names == [n + (f"({a[0]})" if a else "") for n, a in MAIN_PATH]


def lane_inputs(n_in: int, n_lanes: int = 4):
    """Raw Montgomery-domain input values, [n_lanes][n_in]: lanes of all
    p-1, all 0, a 0/1/p-1 cycle, then random canonical values."""
    lanes = [[P - 1] * n_in, [0] * n_in,
             [(0, 1, P - 1)[k % 3] for k in range(n_in)]]
    while len(lanes) < n_lanes:
        lanes.append([rng.randrange(P) for _ in range(n_in)])
    return lanes


@pytest.mark.parametrize("name,args", MAIN_PATH,
                         ids=[n + "".join(map(str, a)) for n, a in MAIN_PATH])
def test_plan_matches_jax_eval_plan_host(name, args):
    port_plan = getattr(pe, name)(*args)
    jax_plan = getattr(jpe, name)(*args)
    compiled = pe.compile_plan(port_plan)
    lanes = lane_inputs(compiled.n_in, 5)
    ops = torch.stack([fp.from_ints([lane[k] for lane in lanes],
                                    to_mont=False, device="cpu")
                       for k in range(compiled.n_in)])  # [K, L, B]
    out = pe.plan_exec(ops, compiled)
    assert out.shape == (len(jax_plan), 24, len(lanes))
    for b, lane in enumerate(lanes):
        exp = jpe.eval_plan_host(jax_plan, lane, P, R)
        got = [int(fp.to_ints(out[o, :, b], from_mont=False))
               for o in range(len(jax_plan))]
        assert got == exp, (name, b)


@pytest.mark.parametrize("name,args", MAIN_PATH,
                         ids=[n + "".join(map(str, a)) for n, a in MAIN_PATH])
def test_table_follows_jax_schedule(name, args):
    """The instruction table holds the JAX plan's level groups in order:
    the same (op, term count) and size per group, every source slot
    written before it is read, and outputs that are slots of the table."""
    compiled = pe.compile_plan(getattr(pe, name)(*args))
    schedule = jpe._plan_schedule(getattr(jpe, name)(*args))
    assert len(compiled.groups) == len(schedule)
    op_of = {v: k for k, v in pe.OP_CODES.items()}
    for (start, stop), group in zip(compiled.groups, schedule):
        rows = compiled.instr[start:stop]
        assert len(rows) == len(group)
        assert {op_of[int(r[0])] for r in rows} == {group[0].op}
        if group[0].op == "sop":
            assert set(rows[:, 2].tolist()) == {len(group[0].args)}
    written = set(range(compiled.n_in))
    for row in compiled.instr:
        op, dst, n_terms = (int(x) for x in row[:3])
        n_src = 2 * n_terms if op == pe.OP_CODES["sop"] else \
            (1 if op == pe.OP_CODES["neg"] else 2)
        assert set(row[3:3 + n_src].tolist()) <= written
        written.add(dst)
    assert set(compiled.out_slots.tolist()) <= written
    assert compiled.n_slots == compiled.n_in + len(compiled.instr)


def _tiny_plan(m):
    """The edge-value plan of tests/test_plan_kernels.py, built with the
    DAG helpers of module m (the port's or the JAX package's)."""
    a, b = m.inp(0), m.inp(1)
    return (
        m.sop([(a, b), (m.sub(a, b), a)]),
        m.add(a, b),
        m.neg(m.add(a, m.sub(b, b))),
    )


def test_tiny_plan_matches_jax_interpret():
    """Ripple add/sub/neg and one sop group over edge values, against the
    JAX plan kernel run in interpret mode."""
    cases = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (P - 1, 1),
             (rng.randrange(P), rng.randrange(P))]
    A = jfp.from_ints([x for x, _ in cases])
    B = jfp.from_ints([y for _, y in cases])
    exp = jpe.run_plan(_tiny_plan(jpe), [A, B], interpret=True)
    got = pe.run_plan(_tiny_plan(pe), [convert.fp_to_torch(A, "cpu"),
                                       convert.fp_to_torch(B, "cpu")])
    for g, e in zip(got, exp):
        assert np.array_equal(convert.fp_from_torch(g), np.asarray(e))
    x = [int(v) for v in fp.to_ints(got[0])]
    assert x == [(a * b + (a - b) * a) % P for a, b in cases]


def test_run_plan_broadcasts_batch_shapes():
    """Inputs of different batch shapes broadcast; outputs take the full
    batch shape."""
    a = fp.from_ints([[3, 5, 7], [11, 13, 17]], device="cpu")  # [L, 2, 3]
    b = fp.from_ints([[2]], device="cpu")                       # [L, 1, 1]
    plan = (pe.sop([(pe.inp(0), pe.inp(1))]), pe.sub(pe.inp(0), pe.inp(1)))
    prod, diff = pe.run_plan(plan, [a, b])
    assert prod.shape == diff.shape == (24, 2, 3)
    assert fp.to_ints(prod).tolist() == [[6, 10, 14], [22, 26, 34]]
    assert fp.to_ints(diff).tolist() == [[1, 3, 5], [9, 11, 15]]


def test_plan_exec_validates_operands():
    compiled = pe.compile_plan(pe.fp12_mul_plan())
    with pytest.raises(ValueError):
        pe.plan_exec(torch.zeros((23, 24, 2), dtype=torch.int32), compiled)
    with pytest.raises(ValueError):
        pe.plan_exec(torch.zeros((24, 24, 2), dtype=torch.int64), compiled)
