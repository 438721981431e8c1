"""The verify path's CUDA graphs (`utils/graphs.py`, `graphed`) on the CPU:
the pairing, the four hash / encode to curve functions and both compressed
decoders route their device bodies through `graphed` under one key a
shape, their values on CPU tensors are as before (CPU tensors never
capture), and a verify call's keys fit in `graphs.SLOTS` across calls.

A capture needs a card (`test_torch_verify_graph_gpu.py` replays there).
Here `graphed` is replaced by a recorder that keeps the key and the shape
state as `graphed` does and returns a stand-in of the body's output, so no
pairing runs on this CPU (one takes ~20 s).

Tolerance: none -- keys compare exactly, values against `hostmath`.
"""

import collections
import sys

import numpy as np
import pytest
import torch

from bls12_381_torch import hostmath as hm, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fp
from bls12_381_torch.hash_to_curve import h2c
from bls12_381_torch.kernels import GRAPHS
from bls12_381_torch.pairing.pairing import pairing
from bls12_381_torch.utils import graphs

DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
DECODERS = (g1._decompress_device, g2._decompress_device)


@pytest.fixture
def recorded(monkeypatch):
    """`graphs.graphed` as a recorder: each call's (name, body, key); the
    shape state moved as `graphed` moves it (a new key remembered, a known
    one the newest); a stand-in output.  Yields the calls."""
    calls = []
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())

    def graphed(name, body, inputs, *args):
        key = graphs._key(body, inputs, *args)
        calls.append((name, body, key))
        graphs._remember(key, graphs._graphs.get(key, graphs._SEEN))
        if body in DECODERS:
            x, inf, _ = inputs
            return (x, x, inf), inf, inf, inf
        return "point"

    monkeypatch.setattr(graphs, "graphed", graphed)
    yield calls


def compressed(group: str, n: int) -> np.ndarray:
    """n encodings of the group's generator, uint8 [n, 48 or 96]."""
    if group == "g1":
        one = hm.g1_to_compressed(params.G1_GEN)
    else:
        one = hm.g2_to_compressed(params.G2_GEN)
    return np.tile(np.frombuffer(one, np.uint8), (n, 1))


def messages(n: int) -> list:
    return [bytes([i % 256]) * 32 for i in range(n)]


def pairing_inputs(n: int):
    def fp(): return torch.zeros((24, n), dtype=torch.int32)
    inf = torch.zeros(n, dtype=torch.bool)
    return (fp(), fp(), inf), ((fp(), fp()), (fp(), fp()), inf)


def run_path(path: str, n: int):
    """One call of the public path `path` at batch n, on the CPU."""
    kind, _, variant = path.partition(":")
    if kind == "pairing":
        return pairing(*pairing_inputs(n))
    if kind in ("g1_decode", "g2_decode"):
        mod = g1 if kind == "g1_decode" else g2
        return mod.from_compressed_host(compressed(kind[:2], n),
                                        check_subgroup=variant == "check",
                                        device="cpu")
    fn = getattr(h2c, kind)
    if variant == "device":
        return fn(messages(n), DST, expand="device", device="cpu")
    return fn(messages(n), DST, device="cpu")


H2C = [f"{fn}:{expand}"
       for fn in ("hash_to_curve_g1", "encode_to_curve_g1",
                  "hash_to_curve_g2", "encode_to_curve_g2")
       for expand in ("host", "device")]
PATHS = (["pairing"] + H2C
         + [f"{g}_decode:{c}" for g in ("g1", "g2")
            for c in ("check", "nocheck")])
REPLAY = {"pairing": "pairing.replay", "g1_decode": "codec.replay",
          "g2_decode": "codec.replay"}


@pytest.mark.parametrize("path", PATHS)
def test_each_path_is_graphed_under_one_key_a_shape(recorded, path):
    """Two calls at one batch: one key; a third at another batch: another.
    The body is a module-level function (a closure made per call would
    key a new graph every call)."""
    for n in (2, 2, 3):
        run_path(path, n)
    assert len(recorded) == 3
    kind = path.partition(":")[0]
    names = {name for name, _, _ in recorded}
    assert names == {REPLAY.get(kind, "h2c.replay")}
    (first, body, key1), (_, _, key2), (_, _, key3) = recorded
    assert key1 == key2 != key3
    assert "<locals>" not in body.__qualname__
    assert getattr(sys.modules[body.__module__], body.__name__) is body
    assert len(graphs._graphs) == 2


def test_the_keys_part_curve_count_expansion_and_check(recorded):
    """Every path and variant at one batch keys a graph of its own."""
    for path in PATHS:
        run_path(path, 2)
    keys = [key for _, _, key in recorded]
    assert len(set(keys)) == len(PATHS)


def test_cpu_values_are_unchanged():
    """With the real `graphed` on CPU tensors the decoder gives the host
    oracle's points and verdicts, and nothing is captured, counted or
    remembered (the hashes' and the pairing's CPU values are held by
    test_torch_h2c.py's KATs and the JAX package, and
    test_torch_roundtrip.py)."""
    before = GRAPHS.snapshot()
    graphs._graphs.clear()
    good = [hm.g1_mul(params.G1_GEN, k) for k in (5, 7)]
    outside = hm.g1_point_outside_subgroup()
    data = np.stack([np.frombuffer(hm.g1_to_compressed(p), np.uint8)
                     for p in good + [outside]])
    data = np.concatenate([data, compressed("g1", 1)])
    data[-1, 0] |= 0b0100_0000  # infinity flag with x != 0: invalid
    aff, valid = g1.from_compressed_host(data, device="cpu")
    assert valid.tolist() == [True, True, False, False]
    x, y, _ = aff
    assert list(zip(fp.to_ints(x[:, :2]), fp.to_ints(y[:, :2]))) == good
    assert GRAPHS.snapshot() == before
    assert not graphs._graphs


def verify_call(b: int, with_key: bool = True):
    """A verify call's public paths at b sets, in the benchmark's call order:
    the keys' decode (not in an aggregate call: the registry holds them),
    the signatures' decode, the hash to G2, one pairing over 2b lanes."""
    if with_key:
        g1.from_compressed_host(compressed("g1", b), device="cpu")
    g2.from_compressed_host(compressed("g2", b), device="cpu")
    h2c.hash_to_curve_g2(messages(b), DST, expand="device", device="cpu")
    pairing(*pairing_inputs(2 * b))


@pytest.mark.parametrize("cell", ["verify", "aggregate"])
def test_a_verify_calls_keys_stay_across_calls(recorded, cell):
    """Set-up leaves one key more than the calls use (the signing hash at
    every set's lanes; for an aggregate cell first the registry's decode
    chunk, then that hash): the first call's new keys push out the oldest
    set-up key, and no key of a call is pushed out across calls."""
    assert graphs.SLOTS == 4
    b = 4
    if cell == "verify":
        h2c.hash_to_curve_g2(messages(8 * b), DST, expand="device",
                             device="cpu")
        setup = [recorded[-1][2]]
    else:
        g1.from_compressed_host(compressed("g1", 16 * b), device="cpu")
        h2c.hash_to_curve_g2(messages(2 * b), DST, expand="device",
                             device="cpu")
        setup = [k for _, _, k in recorded]
    kept = []
    for i in range(3):
        start = len(recorded)
        verify_call(b, with_key=cell == "verify")
        mine = [k for _, _, k in recorded[start:]]
        assert len(mine) == (4 if cell == "verify" else 3)
        assert all(k in graphs._graphs for k in mine), f"call {i}"
        kept.append(list(graphs._graphs))
    assert setup[0] not in kept[0]
    assert kept[0] == kept[1] == kept[2]
    assert len(kept[0]) == graphs.SLOTS
