"""The port's hash to curve (`hash_to_curve/h2c.py`), its device expanders
(`kernels/sha256.py`, `kernels/keccak.py`), `hostmath`'s expanders and
constants, and the launch schedules of the codecs and hash to curve in
`tests/port_cases.py`, on the CPU.

Oracles: hashlib; the draft-16 expansion KATs (tests/vectors/
expand_msg_kats.json) and hash-to-curve KATs (h2c_kats.json); the JAX
package's hash_to_field and map_to_curve on the same inputs (its device
hash_to_curve, whose cofactor clearing takes minutes to compile on the
CPU, is not run).  Tolerance: none (integer arithmetic) -- bytes and limbs
compare exactly; the maps projectively, limb for limb.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

import conftest
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu.fields import fp as jfp, tower as jtw
from bls12_381_tpu.hash_to_curve import h2c as jh2c

import port_cases
from test_torch_smul import count_launches
from bls12_381_torch import convert, entry, hostmath as hm, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.hash_to_curve import h2c
from bls12_381_torch.kernels import keccak, sha256

torch.set_num_threads(1)
np_rng = np.random.RandomState(20261018)

EXPAND = json.loads((conftest.VECTORS / "expand_msg_kats.json").read_text())
H2C = json.loads((conftest.VECTORS / "h2c_kats.json").read_text())
HASH_NAME = {"Sha256": "sha256", "Sha512": "sha512",
             "Shake128": "shake_128", "Shake256": "shake_256"}


def expand_cases(group):
    for c in EXPAND[group]:
        yield (c["msg"].encode(), c["dst"].encode(), c["len_in_bytes"],
               bytes.fromhex(c["uniform_bytes"]), HASH_NAME[c["hash"]])


def one_msg(msg: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(msg, np.uint8).copy()).reshape(
        1, -1)


# --- expanders --------------------------------------------------------------


def test_sha256_and_shake_match_hashlib():
    """Padding edges: 0, 55, 56, 64 and 150 bytes for SHA-256; 0, 167,
    168 and 200 for SHAKE (rates 168 and 136), squeezing past a rate."""
    for n in (0, 55, 56, 64, 150):
        m = np_rng.randint(0, 256, (3, n)).astype(np.uint8)
        got = sha256.sha256(torch.from_numpy(m)).numpy()
        assert [bytes(r) for r in got] == [hashlib.sha256(bytes(r)).digest()
                                           for r in m]
    for n in (0, 167, 168, 200):
        m = np_rng.randint(0, 256, (2, n)).astype(np.uint8)
        t = torch.from_numpy(m)
        assert [bytes(r) for r in keccak.shake128(t, 300).numpy()] == [
            hashlib.shake_128(bytes(r)).digest(300) for r in m]
        assert [bytes(r) for r in keccak.shake256(t, 100).numpy()] == [
            hashlib.shake_256(bytes(r)).digest(100) for r in m]


@pytest.mark.parametrize("dst", [b"QUUX-V01-CS02-with-expander-SHA256-128",
                                 b"y" * 300])
def test_device_expanders_match_host(dst):
    """XMD (SHA-256) and XOF (SHAKE-128/256) on batches of equal-length
    messages, an oversize DST (> 255 bytes) reduced first."""
    for n, out in ((0, 32), (32, 128), (68, 256)):
        m = np_rng.randint(0, 256, (2, n)).astype(np.uint8)
        got = sha256.expand_message_xmd_sha256(m, dst, out, device="cpu")
        assert [bytes(r) for r in got.numpy()] == [
            hm.expand_message_xmd(bytes(r), dst, out) for r in m]
        for bits, name in ((128, "shake_128"), (256, "shake_256")):
            got = keccak.expand_message_xof_shake(m, dst, out, bits=bits,
                                                  device="cpu")
            assert [bytes(r) for r in got.numpy()] == [
                hm.expand_message_xof(bytes(r), dst, out, hash_name=name)
                for r in m]
    with pytest.raises(ValueError, match="equal-length"):
        sha256.expand_message_xmd_sha256([b"a", b"bc"], dst, 32,
                                         device="cpu")


@pytest.mark.parametrize("group", sorted(EXPAND))
def test_expansion_kats(group):
    """Every draft-16 appendix case through hostmath's expander, and through
    the device expander where it implements the hash (SHA-256, SHAKE),
    oversize DSTs included."""
    for msg, dst, n, want, name in expand_cases(group):
        host = hm.expand_message_xof if "xof" in group else \
            hm.expand_message_xmd
        assert host(msg, dst, n, hash_name=name) == want
        if name == "sha256":
            got = sha256.expand_message_xmd_sha256(one_msg(msg), dst, n)
        elif name.startswith("shake"):
            got = keccak.expand_message_xof_shake(
                one_msg(msg), dst, n, bits=128 if name == "shake_128"
                else 256)
        else:
            continue
        assert bytes(got[0].numpy()) == want, (group, msg[:16], n)


def test_constants_match_ref_constants_json():
    """The SSWU and isogeny literals of `params.ISO_CONSTS` against the
    values the JAX package reads from tests/vectors/ref_constants.json."""
    raw = json.loads((conftest.VECTORS / "ref_constants.json").read_text())

    def dec(v):
        return int(v, 16) if isinstance(v, str) else tuple(dec(x) for x in v)

    assert set(params.ISO_CONSTS) <= set(raw)
    for key, value in params.ISO_CONSTS.items():
        assert value == dec(raw[key]), key
        assert value == jhm.ISO_CONSTS[key], key


# --- hash_to_field ----------------------------------------------------------


DST_RO = {"g1": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_",
          "g2": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"}
DST_NU = {"g1": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_NU_",
          "g2": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_NU_"}
MSGS = [b"device-%02d" % i for i in range(4)]


def same(got, want) -> bool:
    if isinstance(got, tuple):
        return all(same(a, b) for a, b in zip(got, want))
    return np.array_equal(got.numpy().astype(np.int64),
                          np.asarray(want).astype(np.int64))


def test_hash_to_field_fp_matches_jax():
    dst = DST_RO["g1"]
    want = jh2c.hash_to_field_fp(MSGS, dst, 2)
    assert same(h2c.hash_to_field_fp(MSGS, dst, 2, device="cpu"), want)
    assert same(h2c.hash_to_field_fp_device(MSGS, dst, 2, device="cpu"),
                jh2c.hash_to_field_fp_device(MSGS, dst, 2))
    assert same(h2c.hash_to_field_fp_device(MSGS, dst, 2, device="cpu"), want)
    # the XOF host expander, keywords passed through
    assert same(h2c.hash_to_field_fp(MSGS, dst, 1, hm.expand_message_xof,
                                     device="cpu", hash_name="shake_256"),
                jh2c.hash_to_field_fp(MSGS, dst, 1, jhm.expand_message_xof,
                                      hash_name="shake_256"))


def test_hash_to_field_fp2_and_fr_match_jax():
    dst = DST_RO["g2"]
    want = jh2c.hash_to_field_fp2(MSGS, dst, 2)
    assert same(h2c.hash_to_field_fp2(MSGS, dst, 2, device="cpu"), want)
    assert same(h2c.hash_to_field_fp2_device(MSGS, dst, 2, device="cpu"),
                jh2c.hash_to_field_fp2_device(MSGS, dst, 2))
    assert same(h2c.hash_to_field_fp2_device(MSGS, dst, 2, device="cpu"),
                want)
    fr_want = jh2c.hash_to_field_fr(MSGS, dst, 3)
    assert same(h2c.hash_to_field_fr(MSGS, dst, 3, device="cpu"), fr_want)
    assert same(h2c.hash_to_field_fr_device(MSGS, dst, 3, device="cpu"),
                fr_want)


# --- map_to_curve against the JAX package --------------------------------


def test_map_to_curve_g1_matches_jax():
    """Projective outputs limb for limb at 4 lanes, u = 0 (the exceptional
    tv = 0 case) among them; their affine points are the host oracle's."""
    vals = [0, 1, 2, 3]
    u = jfp.from_ints(vals)
    got = h2c.map_to_curve_g1(convert.fp_to_torch(np.asarray(u), "cpu"))
    assert same(got, jh2c.map_to_curve_g1(u))
    assert port_cases.affine_to_host("g1", g1.to_affine(got)) == [
        jhm.map_to_curve_g1(v) for v in vals]


def test_map_to_curve_g2_matches_jax():
    vals = [(0, 0), (1, 0), (0, 1), (5, 7)]
    u = jtw.fp2_from_ints(vals)
    tu = tuple(convert.fp_to_torch(np.asarray(c), "cpu") for c in u)
    got = h2c.map_to_curve_g2(tu)
    assert same(got, jh2c.map_to_curve_g2(u))
    assert port_cases.affine_to_host("g2", g2.to_affine(got)) == [
        jhm.map_to_curve_g2(v) for v in vals]


# --- the draft-16 hash-to-curve KATs --------------------------------------


@pytest.mark.parametrize("name", ["g1_ro", "g1_nu", "g2_ro", "g2_nu"])
def test_h2c_kats(name):
    """hash_to_curve (ro) / encode_to_curve (nu) equal the five expected
    points with the host expander, in one call.  The device expander
    gives the same field elements for all five messages, and the whole
    device pipeline the expected points for the shortest and the longest
    message, one call each (it takes equal-length messages only; every
    KAT runs through it on the card, `test_torch_verify_graph_gpu.py`)."""
    group = name[:2]
    mod = {"g1": g1, "g2": g2}[group]
    kind = "hash" if name.endswith("ro") else "encode"
    fn = getattr(h2c, f"{kind}_to_curve_{group}")
    dst = (DST_RO if name.endswith("ro") else DST_NU)[group]
    msgs = [c["msg"].encode() for c in H2C[name]]
    want = [c["expected"] for c in H2C[name]]

    def hexes(out):
        return [bytes(r).hex()
                for r in mod.to_uncompressed_host(mod.to_affine(out))]

    assert hexes(fn(msgs, dst, device="cpu")) == want
    count = 2 if kind == "hash" else 1
    field, field_device = {
        "g1": (h2c.hash_to_field_fp, h2c.hash_to_field_fp_device),
        "g2": (h2c.hash_to_field_fp2, h2c.hash_to_field_fp2_device)}[group]
    for m in msgs:
        assert same(field_device([m], dst, count, device="cpu"),
                    field([m], dst, count, device="cpu"))
    short, long = min(range(5), key=lambda i: len(msgs[i])), \
        max(range(5), key=lambda i: len(msgs[i]))
    for i in (short, long):
        assert hexes(fn([msgs[i]], dst, expand="device", device="cpu")) == [
            want[i]]


# --- launch schedules of the codecs and hash to curve ---------------------
# (the plain versions' calls counted by test_torch_smul.count_launches)


@pytest.mark.parametrize("group,form", [(g, f) for g in ("g1", "g2")
                                        for f in port_cases.CODEC_FORMS])
def test_phase_codec_launch_schedules(group, form):
    """Each decoder (check on) and encoder against
    `port_cases.expected_codec_launches`, on `entry.codec_inputs` at 32
    lanes."""
    n = 32
    fn, (data,) = entry.codec_entry(5, group, form, device="cpu")
    name = f"from_{form}_host"
    counts, (aff, valid) = count_launches(fn, data)
    assert counts == port_cases.expected_codec_launches(group, name, n)
    assert valid.tolist() == [i % 64 != entry.CODEC_BAD_LANE
                              for i in range(n)]
    mod = {"g1": g1, "g2": g2}[group]
    counts, out = count_launches(getattr(mod, f"to_{form}_host"), aff)
    assert counts == port_cases.expected_codec_launches(
        group, f"to_{form}_host", n)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("group,kind", port_cases.H2C_ROWS)
def test_phase_h2c_launch_schedules(group, kind):
    """Each h2c row (device expansion) against
    `port_cases.expected_h2c_launches`, at 2 lanes (no step depends on
    the lane count)."""
    fn, args = entry.h2c_entry(1, group, kind, device="cpu")
    counts, _ = count_launches(fn, *args)
    assert counts == port_cases.expected_h2c_launches(group, kind, 2)
