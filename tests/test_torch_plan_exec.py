"""The port's expression plans (bls12_381_torch.kernels.plan_exec) against
the JAX package's plans.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of integers or 16-bit limbs.  Each main-path plan is built by the port,
compiled to its instruction table and run by the table's plain executor;
the JAX package's own plan of the same name is evaluated lane by lane with
its pure-Python oracle `eval_plan_host`, which the port's copy of it
equals.  Inputs come from a seeded generator plus the edge values 0, 1 and
p-1.
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
def test_eval_plan_host_matches_jax(name, args):
    """The port's host plan oracle on its own plan equals the JAX
    package's on the JAX plan of the same name."""
    port_plan = getattr(pe, name)(*args)
    jax_plan = getattr(jpe, name)(*args)
    lanes = lane_inputs(pe.compile_plan(port_plan).n_in, 4)
    for lane in lanes:
        assert pe.eval_plan_host(port_plan, lane, P, R) == \
            jpe.eval_plan_host(jax_plan, lane, P, R)


def sources(n):
    return [x for pair in n.args for x in pair] if n.op == "sop" else \
        list(n.args)


def depths(outputs) -> dict:
    depth = {}

    def visit(n):
        if n not in depth:
            depth[n] = 0 if n.op == "in" else \
                1 + max(visit(x) for x in sources(n))
        return depth[n]

    for o in outputs:
        visit(o)
    return depth


def replay_table(outputs, compiled):
    """Walk the compiled table phase by phase, tracking which DAG node each
    slot holds, with the DAG as the judge.  Every row is the node of its
    position in the schedule; every read gets the node the DAG names; no
    slot is written twice, or written and read, in one phase; phases break
    exactly where the depth changes; the outputs end in their slots; and
    `n_slots` is the peak live count, a value living from its phase to the
    phase of its last read (outputs to the end)."""
    outputs = tuple(outputs)
    depth = depths(outputs)
    nodes = [n for g in pe._plan_schedule(outputs) for n in g]
    assert len(nodes) == len(compiled.instr)
    op_of = {v: k for k, v in pe.OP_CODES.items()}
    held = {}
    for row_k, s in compiled.loads.tolist():
        assert s not in held
        held[s] = pe.inp(row_k)
    starts = [s for s, _ in compiled.phases]
    assert [e for _, e in compiled.phases] == starts[1:] + [len(nodes)]
    for p0, p1 in compiled.phases:
        assert len({depth[n] for n in nodes[p0:p1]}) == 1
        assert p0 == 0 or depth[nodes[p0 - 1]] < depth[nodes[p0]]
        read, written = set(), {}
        for row, n in zip(compiled.instr[p0:p1], nodes[p0:p1]):
            op, dst, t = (int(x) for x in row[:3])
            assert op_of[op] == n.op
            assert t == (len(n.args) if n.op == "sop" else 0)
            srcs = row[3:3 + pe.n_sources(op, t)].tolist()
            assert [held.get(s) for s in srcs] == sources(n)
            read.update(srcs)
            assert dst not in written
            written[dst] = n
        assert not read & written.keys()
        held.update(written)
    assert [held[s] for s in compiled.out_slots.tolist()] == list(outputs)
    # the peak live count, from the DAG alone
    last = {}
    for n in nodes:
        for x in sources(n):
            last[x] = max(last.get(x, 0), depth[n])
    end = 1 + max(depth.values())
    last.update((o, end) for o in outputs)
    peak = max(sum(depth[v] <= p <= last[v] for v in last)
               for p in range(end))
    assert compiled.n_slots == peak
    assert max(held) < compiled.n_slots


@pytest.mark.parametrize("name,args", MAIN_PATH,
                         ids=[n + "".join(map(str, a)) for n, a in MAIN_PATH])
def test_table_follows_jax_schedule(name, args):
    """The instruction table holds the JAX plan's level groups in order:
    the same (op, term count) and size per group; its replay against the
    port's DAG finds every read right and no slot hazard in a phase."""
    outputs = getattr(pe, name)(*args)
    compiled = pe.compile_plan(outputs)
    schedule = jpe._plan_schedule(getattr(jpe, name)(*args))
    assert len(compiled.groups) == len(schedule)
    op_of = {v: k for k, v in pe.OP_CODES.items()}
    for (start, stop), group in zip(compiled.groups, schedule):
        rows = compiled.instr[start:stop]
        assert len(rows) == len(group)
        assert {op_of[int(r[0])] for r in rows} == {group[0].op}
        if group[0].op == "sop":
            assert set(rows[:, 2].tolist()) == {len(group[0].args)}
    replay_table(outputs, compiled)


@pytest.mark.parametrize("make_plan", pe.GROUP_LAW_PLANS,
                         ids=lambda b: b.__name__)
def test_group_law_table_replays(make_plan):
    replay_table(make_plan(), pe.compile_plan(make_plan()))


ALL_PLANS = pe.MAIN_PATH_PLANS + pe.GROUP_LAW_PLANS


def decode_program(prog: np.ndarray):
    """The kernel's byte program back to (phases, instr, loads, out_slots,
    n_slots), reading the layout csrc/plan_exec.cu reads."""
    buf = prog.tobytes()

    def u16(off, n):
        return np.frombuffer(buf, "<u2", n, off).tolist()

    n_phases, n_loads, n_out, n_slots, o_ph, o_at, o_io, o_rows = u16(0, 8)
    bounds = u16(o_ph, n_phases + 1)
    rows_at = u16(o_at, bounds[-1])
    io = list(buf[o_io:o_io + 2 * n_loads + n_out])
    instr = np.zeros((len(rows_at), pe.INSTR_WIDTH), np.int32)
    for i, at in enumerate(rows_at):
        row = buf[o_rows + 4 * at:]
        op, t = row[0] & 15, row[0] >> 4
        n_src = pe.n_sources(op, t)
        instr[i, :3 + n_src] = [op, row[1], t, *row[2:2 + n_src]]
    return (tuple(zip(bounds, bounds[1:])), instr,
            np.array(io[:2 * n_loads]).reshape(-1, 2), io[2 * n_loads:],
            n_slots)


@pytest.mark.parametrize("make_plan", ALL_PLANS,
                         ids=lambda b: pe.compile_plan(b()).name)
def test_program_encodes_table(make_plan):
    """The kernel's compact program holds the same table: rows, phases,
    loads and outputs, in a few KB."""
    c = pe.compile_plan(make_plan())
    prog = c.tables(torch.device("cpu")).program.numpy()
    assert np.array_equal(prog, c.program)
    phases, instr, loads, outs, n_slots = decode_program(prog)
    assert phases == c.phases
    assert np.array_equal(instr, c.instr)
    assert np.array_equal(loads, c.loads)
    assert outs == c.out_slots.tolist() and n_slots == c.n_slots
    assert len(prog) <= 3 * 1024


@pytest.mark.parametrize("make_plan", ALL_PLANS,
                         ids=lambda b: pe.compile_plan(b()).name)
def test_launch_shape(make_plan):
    """One lane at B = 1 and 130; at the pairing's batch 8 lanes, a block for
    128 of the 132 SMs; a power of two that keeps half the SMs busy and
    the block's program and slots within the shared-memory budget."""
    c = pe.compile_plan(make_plan())
    assert c.launch_shape(1)[0] == c.launch_shape(130)[0] == 1
    assert c.launch_shape(1024)[0] == 8
    for B in (1, 7, 130, 1021, 1024, 1 << 13, 1 << 16):
        lt, threads, smem = c.launch_shape(B)
        assert lt & (lt - 1) == 0 and lt <= pe.MAX_LANE_TILE
        assert threads == pe.THREADS
        assert smem == len(c.program) + 4 * c.n_slots * pe.slot_words(lt)
        assert smem <= pe.SMEM_BUDGET
        assert lt == 1 or -(-B // lt) >= pe.SM_COUNT // 2


def test_plain_reads_phase_before_writing():
    """A hand-made table whose one phase writes the slots it reads,
    (s0, s1) <- (s0 + s1, s0 - s1): the plain version reads every source
    of the phase before it writes, as the kernel's barrier does, so it
    gives (a + b, a - b), not the in-order (a + b, a)."""
    instr = np.zeros((2, pe.INSTR_WIDTH), np.int32)
    instr[0, [0, 1, 3, 4]] = pe.OP_CODES["add"], 0, 0, 1
    instr[1, [0, 1, 3, 4]] = pe.OP_CODES["sub"], 1, 0, 1
    plan = pe.CompiledPlan(
        name="swap", n_in=2, n_slots=2, instr=instr,
        groups=((0, 1), (1, 2)), phases=((0, 2),),
        loads=np.array([[0, 0], [1, 1]], np.int32),
        out_slots=np.array([0, 1], np.int32))
    cases = [(P - 1, P - 1), (0, 1), (rng.randrange(P), rng.randrange(P))]
    a = fp.from_ints([x for x, _ in cases], to_mont=False, device="cpu")
    b = fp.from_ints([y for _, y in cases], to_mont=False, device="cpu")
    s, d = pe.plan_exec(torch.stack([a, b]), plan)
    assert fp.to_ints(s, from_mont=False).tolist() == \
        [(x + y) % P for x, y in cases]
    assert fp.to_ints(d, from_mont=False).tolist() == \
        [(x - y) % P for x, y in cases]


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
