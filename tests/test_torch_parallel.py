"""The port's sharded paths (`bls12_381_torch/parallel/`, counterpart of
`bls12_381_tpu/parallel/`) on the CPU, across ranks of a gloo process
group, against the port's local paths, the JAX package's host oracle and
its NTTs (`ops.ntt.ntt`, and `parallel.ntt_sharded` on four of the
conftest's eight virtual CPU devices).

Tolerance: none (integer arithmetic).  Field elements and transforms
compare limb for limb; MSM results in affine coordinates (the order of the
ranks' partial sums changes projective limbs, not points); the aggregate
Miller value is a field element and equals `multi_miller_loop`'s exactly.

Four ranks are spawned once for the module (start method spawn, one host
thread each) and run `port_cases.parallel_job` (which the card test runs
on cuda:0 at full width) at small sizes: the 1-D mesh of four ranks and,
in the same world, the 2 x 2 mesh; MSMs of 32 points with window 4, NTTs
of 2^6 and 2^7 (n1 != n2 at 2^7), a pairing batch of 8 lanes with
identity lanes, and `entry.multichip_entry(4)`.  The launch schedule the
card test holds the card to is checked here at one rank, by counting the
plain versions' calls.
"""

import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import conftest  # noqa: F401
from bls12_381_tpu import hostmath as jhm, limbs as jlb, params as jparams
from bls12_381_tpu.ops import ntt as jntt

import port_cases
from bls12_381_torch import convert, entry, params
from bls12_381_torch import pairing as pr
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fr, tower as tw
from bls12_381_torch.kernels import LAUNCHES, mont
from bls12_381_torch.ops import ntt
from bls12_381_torch.parallel import (mesh as mesh_mod, msm_g1_sharded,
                                      msm_g2_sharded, ntt_sharded,
                                      pairing_sharded)
from bls12_381_torch.parallel.ntt_sharded import split

torch.set_num_threads(1)
RANKS = 4
WINDOW = 4
MSM_LOG_N = 5
NTT_LOG_NS = (6, 7)
PAIRING_B = 8
P_IDENTITY, Q_IDENTITY = 3, 6  # an identity lane on each side


def pairing_inputs():
    """P_i = [i+1]G1, Q_i = [2i+1]G2 with one identity lane each."""
    p, q = entry.tiny_pairing_inputs(PAIRING_B, "cpu")
    p_inf = torch.arange(PAIRING_B) == P_IDENTITY
    q_inf = torch.arange(PAIRING_B) == Q_IDENTITY
    return p[:2] + (p_inf,), q[:2] + (q_inf,)


def make_inputs() -> dict:
    xs = {k: entry.ntt_inputs(k, seed=k, device="cpu") for k in NTT_LOG_NS}
    return {"pairing": pairing_inputs(), "ntt": xs,
            "ntt_y": {k: ntt.ntt(x) for k, x in xs.items()},
            "msm_g1": entry.msm_inputs(MSM_LOG_N, "g1", device="cpu"),
            "msm_g2": entry.msm_inputs(MSM_LOG_N, "g2", device="cpu")}


INPUTS = make_inputs()
ROWS_1D = ["pairing", "pairing_agg", "pairing_agg_fe", "msm_g1", "msm_g2"] + [
    f"{kind}_{k}" for k in NTT_LOG_NS for kind in ("ntt", "intt")]
ROWS_2D = [f"{row}_2x2" for row in ROWS_1D if row == "msm_g1"
           or row.split("_")[0] in ("ntt", "intt")]


@pytest.fixture(scope="module")
def ranks():
    """Every rank's `port_cases.parallel_job` values, in rank order."""
    spec = {"device": "cpu", "window": WINDOW, "reps": 0, "values": True}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "inputs.pt")
        torch.save(INPUTS, path)
        return port_cases.spawn_ranks(RANKS, "gloo", spec, path, tmp)


@pytest.fixture(scope="module")
def local():
    """The local path's value of each row."""
    return {row: post(call()) for row, (call, post) in
            port_cases.parallel_local(INPUTS, WINDOW).items()}


def same(a, b) -> bool:
    return port_cases.same_tree(a, b)


@pytest.mark.parametrize("row", ROWS_1D + ROWS_2D + ["entry"])
def test_every_rank_holds_the_same_value(ranks, row):
    assert {r for r in ranks[0]} == set(ROWS_1D + ROWS_2D + ["entry",
                                                            "shards"])
    first = ranks[0][row] if row == "entry" else ranks[0][row]["value"]
    for res in ranks[1:]:
        got = res[row] if row == "entry" else res[row]["value"]
        if row == "entry":
            for a, b in zip(got, first):
                assert all(same(a[k], b[k]) for k in a)
        else:
            assert same(got, first)


@pytest.mark.parametrize("row", ROWS_1D + ROWS_2D)
def test_sharded_row_equals_the_local_path(ranks, local, row):
    """pairing = `pairing` lane for lane; pairing_agg = `multi_miller_loop`;
    pairing_agg_fe = its final exponentiation; the MSMs = the local MSM in
    affine; the NTTs = `ntt` / `intt` limb for limb (1-D and 2 x 2)."""
    assert same(ranks[0][row]["value"], local[row.split("_2x")[0]])


@pytest.mark.parametrize("log_n", NTT_LOG_NS)
def test_ntt_sharded_equals_the_jax_ntt(ranks, log_n):
    x = convert.fr_from_torch(INPUTS["ntt"][log_n])
    fwd = jntt.ntt(jnp.asarray(x))
    for suffix in ("", "_2x2"):
        got = ranks[0][f"ntt_{log_n}{suffix}"]["value"]
        assert np.array_equal(convert.fr_from_torch(got), np.asarray(fwd))
        back = ranks[0][f"intt_{log_n}{suffix}"]["value"]
        assert np.array_equal(convert.fr_from_torch(back), x)
        assert np.array_equal(np.asarray(jntt.ntt(fwd, inverse=True)), x)


def test_ntt_sharded_equals_the_jax_ntt_sharded(ranks):
    """The JAX four-step on a mesh of four virtual CPU devices at 2^6."""
    from jax.sharding import Mesh

    from bls12_381_tpu.parallel import ntt_sharded as jntt_sharded

    log_n = NTT_LOG_NS[0]
    x = convert.fr_from_torch(INPUTS["ntt"][log_n])
    jlb.set_pallas(False)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            mesh = Mesh(np.array(conftest.cpu_devices(8)[:RANKS]), ("x",))
            want = np.asarray(jntt_sharded(mesh, jnp.asarray(x)))
    finally:
        jlb.set_pallas(None)
    got = convert.fr_from_torch(ranks[0][f"ntt_{log_n}"]["value"])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("axis_name", port_cases.SHARD_AXES,
                         ids=port_cases.shard_label)
def test_shard_batch_matches_jax_named_sharding(ranks, axis_name):
    """`shard_batch(mesh, lanes, axis_name=...)` on the 2 x 2 gloo mesh
    gives every rank the lanes that the JAX package's `shard_batch` (a
    NamedSharding) places on the device at the rank's mesh position, the
    2 x 2 mesh of four virtual CPU devices; and `port_cases`'s
    `expected_shards`, which the card test holds the card to."""
    from bls12_381_tpu.parallel import mesh as jmesh

    label = port_cases.shard_label(axis_name)
    mesh = jmesh.make_mesh_2d(2, RANKS // 2)
    arr = jmesh.shard_batch(mesh, np.arange(2 * RANKS), axis_name=axis_name)
    seen = set()
    for shard in arr.addressable_shards:
        h, x = np.argwhere(mesh.devices == shard.device)[0]
        rank = int(h) * (RANKS // 2) + int(x)
        seen.add(rank)
        want = np.asarray(shard.data).tolist()
        assert ranks[rank]["shards"][label] == want
        assert port_cases.expected_shards(rank, RANKS)[label] == want
    assert seen == set(range(RANKS))


def jax_tree(tree):
    """numpy leaves of a nested tuple as jax arrays."""
    if isinstance(tree, tuple):
        return tuple(jax_tree(t) for t in tree)
    return jnp.asarray(tree)


@pytest.mark.heavy
def test_msm_g1_and_aggregate_pairing_equal_the_jax_sharded(ranks):
    """The JAX msm_g1_sharded (window 4) and aggregate pairing_sharded
    (final_exp=False) on a mesh of four virtual CPU devices: the same point
    in affine, the same Miller value limb for limb."""
    from jax.sharding import Mesh

    from bls12_381_tpu.curves import g1 as jg1
    from bls12_381_tpu.parallel import msm_g1_sharded as jmsm
    from bls12_381_tpu.parallel import pairing_sharded as jpairing

    pts, sc = INPUTS["msm_g1"]
    p, q = INPUTS["pairing"]
    jlb.set_pallas(False)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            mesh = Mesh(np.array(conftest.cpu_devices(8)[:RANKS]), ("x",))
            point = jg1.to_affine(tuple(x[..., None] for x in jmsm(
                mesh, jax_tree(convert.g1_proj_from_torch(pts)),
                jnp.asarray(convert.fr_from_torch(sc)), c=WINDOW)))
            agg = jpairing(mesh, jax_tree(convert.g1_affine_from_torch(p)),
                           jax_tree(convert.g2_affine_from_torch(q)),
                           aggregate=True, final_exp=False)
    finally:
        jlb.set_pallas(None)
    x, y, inf = ranks[0]["msm_g1"]["value"]
    assert np.array_equal(convert.fp_from_torch(x), np.asarray(point[0]))
    assert np.array_equal(convert.fp_from_torch(y), np.asarray(point[1]))
    assert bool(inf[0]) == bool(np.asarray(point[2])[0])
    got = convert.fp12_from_torch(ranks[0]["pairing_agg"]["value"])
    for g6, e6 in zip(got, agg):
        for g2_, e2 in zip(g6, e6):
            for gc, ec in zip(g2_, e2):
                assert np.array_equal(gc, np.asarray(ec))


def msm_host(group: str):
    """The JAX package's host oracle's [sum_i k_i (i+1)]G over the MSM
    inputs (identity lanes skipped)."""
    pts, sc = INPUTS[f"msm_{group}"]
    mod = {"g1": g1, "g2": g2}[group]
    inf = mod.is_identity(pts).tolist()
    ks = [int(k) for k in fr.to_ints(sc)]
    total = sum(k * (i + 1) for i, (k, o) in enumerate(zip(ks, inf))
                if not o) % params.Q
    if group == "g1":
        return jhm.g1_mul(jparams.G1_GEN, total)
    return jhm.g2_mul(jparams.G2_GEN, total)


@pytest.mark.parametrize("row", ["msm_g1", "msm_g2", "msm_g1_2x2"])
def test_msm_sharded_equals_the_host_oracle(ranks, row):
    group = row[4:6]
    got = port_cases.affine_to_host(group, ranks[0][row]["value"])
    assert got == [msm_host(group)]


def test_aggregate_pairing_equals_the_host_product(ranks):
    """The final-exponentiated product = e(G1, G2)^(sum (i+1)(2i+1)) over
    the lanes that are not the identity on either side."""
    s = sum((i + 1) * (2 * i + 1) for i in range(PAIRING_B)
            if i not in (P_IDENTITY, Q_IDENTITY)) % params.Q
    want = jhm.fp12_pow(jhm.pairing(jparams.G1_GEN, jparams.G2_GEN), s)
    assert port_cases.fp12_host(ranks[0]["pairing_agg_fe"]["value"]) == want


def test_elementwise_pairing_keeps_the_identity_lanes(ranks):
    f = ranks[0]["pairing"]["value"]
    one = tw.fp12_one((1,), "cpu")
    for lane in (P_IDENTITY, Q_IDENTITY):
        assert same(port_cases.to_cpu(tuple(tuple(tuple(
            c[..., lane:lane + 1] for c in c2) for c2 in c6) for c6 in f)),
            one)


def test_multichip_entry(ranks):
    """entry.multichip_entry(4) on every rank: the MSM on the 1-D and 2-D
    meshes = the host's [sum k_i]G, the NTT = `ntt`, the aggregate Miller
    value = `multi_miller_loop` of the same inputs."""
    results, ins = ranks[0]["entry"]
    k = sum(int(v) for v in fr.to_ints(ins["msm"][1])) % params.Q
    for key in ("msm", "msm_2d"):
        assert port_cases.affine_ints("g1", results[key]) == jhm.g1_mul(
            jparams.G1_GEN, k)
    assert ins["ntt"].shape == (16, 64)
    assert torch.equal(results["ntt"], ntt.ntt(ins["ntt"]))
    p, q = ins["pairing"]
    assert same(results["pairing"], pr.multi_miller_loop(p, pr.prepare_g2(q)))


# ---------------------------------------------------------------------------
# One process: the mesh's errors, and the launch schedules at one rank
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_mesh_2d(2, 2)


def test_make_mesh_refuses_a_world_of_another_size(world_of_one):
    assert mesh_mod.make_mesh().size() == 1
    for make in (lambda: mesh_mod.make_mesh(2),
                 lambda: mesh_mod.make_mesh_2d(2, 2)):
        with pytest.raises(RuntimeError, match="needs a world of"):
            make()


def test_uneven_batches_and_sizes_raise(world_of_one):
    mesh = mesh_mod.make_mesh()
    assert mesh_mod.shard_size(mesh, 7) == 7
    with pytest.raises(ValueError, match="does not shard evenly"):
        mesh_mod.shard_size(types.SimpleNamespace(size=lambda: 4), 6)
    with pytest.raises(ValueError, match="power of two"):
        ntt_sharded(mesh, torch.zeros((16, 48), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not shard"):
        split(8, 4)  # [2, 4]: two rows over four ranks
    assert split(1 << 7, 4) == (8, 16)
    assert split(1 << 20, 4) == (1024, 1024)
    assert split(1 << 6, 8) == (8, 8)


def test_shard_batch_refuses_unknown_axes(world_of_one):
    mesh = mesh_mod.make_mesh()
    t = torch.arange(4)
    assert torch.equal(mesh_mod.shard_batch(mesh, t, axis_name="x"), t)
    assert torch.equal(mesh_mod.shard_batch(mesh, t, axis_name=("x",)), t)
    for bad in ("host", ("x", "x"), ()):
        with pytest.raises(ValueError, match="does not name"):
            mesh_mod.shard_batch(mesh, t, axis_name=bad)


def test_replicate_and_gather_at_one_rank(world_of_one):
    mesh = mesh_mod.make_mesh()
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    (r,) = mesh_mod.replicate(mesh, (t,))
    assert torch.equal(r, t) and r.data_ptr() != t.data_ptr()
    assert torch.equal(mesh_mod.gather_batch(mesh_mod.shard_batch(
        mesh, t)), t)
    assert mesh_mod.rank_device("cpu") == torch.device("cpu")


def test_elementwise_pairing_final_exponentiates_whatever_final_exp_says(
        world_of_one):
    """aggregate=False returns the final-exponentiated pairings with
    final_exp=False too, as the JAX `_elem` does (it ignores final_exp):
    limb for limb the final_exp=True value, at one rank over two lanes, one
    of them a G1 identity."""
    mesh = mesh_mod.make_mesh()
    p, q = port_cases.pick_lanes(INPUTS["pairing"], [P_IDENTITY - 1,
                                                     P_IDENTITY])
    want = pairing_sharded(mesh, p, q)
    assert same(pairing_sharded(mesh, p, q, final_exp=False), want)
    assert same(want, pr.pairing(p, q))


SCHEDULE_CASES = [
    ("pairing", PAIRING_B), ("pairing_agg", PAIRING_B),
    ("pairing_agg_fe", PAIRING_B), ("msm_g1", 1 << MSM_LOG_N),
    ("msm_g2", 1 << MSM_LOG_N), ("ntt", 1 << 6), ("intt", 1 << 7)]


@pytest.mark.parametrize("kind,n", SCHEDULE_CASES,
                         ids=[k for k, _ in SCHEDULE_CASES])
def test_expected_parallel_launches_at_one_rank(world_of_one, monkeypatch,
                                                kind, n):
    """`port_cases.expected_parallel_launches` for a mesh of one rank
    equals the plain versions' calls of one sharded call (after a warm-up
    that caches the NTT's twiddle table); `count_launches` counts the row
    kernel's, the plan's and the powers', the butterfly's is counted
    here."""
    from test_torch_smul import count_launches

    real_butterfly = mont.butterfly_plain

    def butterfly(*args):
        LAUNCHES.butterfly += 1
        return real_butterfly(*args)

    monkeypatch.setattr(mont, "butterfly_plain", butterfly)

    mesh = mesh_mod.make_mesh()
    p, q = INPUTS["pairing"]
    calls = {
        "pairing": lambda: pairing_sharded(mesh, p, q),
        "pairing_agg": lambda: pairing_sharded(mesh, p, q, aggregate=True,
                                               final_exp=False),
        "pairing_agg_fe": lambda: pairing_sharded(mesh, p, q,
                                                  aggregate=True),
        "msm_g1": lambda: msm_g1_sharded(mesh, *INPUTS["msm_g1"], c=WINDOW),
        "msm_g2": lambda: msm_g2_sharded(mesh, *INPUTS["msm_g2"], c=WINDOW),
        "ntt": lambda: ntt_sharded(mesh, INPUTS["ntt"][6]),
        "intt": lambda: ntt_sharded(mesh, INPUTS["ntt_y"][7], inverse=True),
    }
    if kind in ("ntt", "intt"):
        calls[kind]()
    got, _ = count_launches(calls[kind])
    want = port_cases.expected_parallel_launches(kind, n, (1,), WINDOW)
    assert {k: got[k] for k in want} == want
