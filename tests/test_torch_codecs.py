"""The port's G1/G2 byte codecs (`curves/g1.py`, `curves/g2.py`:
`to_compressed_host`, `to_uncompressed_host`, `from_compressed_host`,
`from_uncompressed_host`) on the CPU: the reference's 1000-point walks
(tests/vectors/*.dat: 0, G, ..., 999G) byte for byte, the subgroup check,
the flag-bit rejects of the verify skill's probes, and the JAX package's
codecs on the same bytes.

Tolerance: none (integer arithmetic) -- bytes, limbs and masks compare
exactly.  Points outside the subgroups come from `hostmath`; the rejects
from `port_cases.reject_cases` (flag bits, infinity with a nonzero x or the
sort bit, x >= p, an x or a point off the curve).
"""

import numpy as np
import pytest
import torch

import conftest
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu.curves import g1 as jg1, g2 as jg2

import port_cases
from bls12_381_torch import hostmath as hm, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.utils import scans

torch.set_num_threads(1)

GROUPS = {"g1": (g1, jg1), "g2": (g2, jg2)}
FORMS = ("compressed", "uncompressed")
CHECK = {"compressed": "check_subgroup", "uncompressed": "check"}


def walk(group: str, form: str) -> np.ndarray:
    raw = (conftest.VECTORS / f"{group}_{form}_valid_test_vectors.dat") \
        .read_bytes()
    return np.frombuffer(raw, np.uint8).reshape(1000, -1)


def leaves(x):
    return [np.asarray(t).astype(np.int64) if not isinstance(t, torch.Tensor)
            else t.numpy().astype(np.int64) for t in scans.tree_leaves(x)]


def same_points(port, jax_pt) -> bool:
    jl = [np.asarray(t) for t in jax_tree(jax_pt)]
    return all(np.array_equal(a, b.astype(np.int64))
               for a, b in zip(leaves(port), jl))


def jax_tree(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in jax_tree(y)]
    return [x]


@pytest.mark.parametrize("group,form", [(g, f) for g in GROUPS
                                        for f in FORMS])
def test_walk_round_trips_without_the_check(group, form):
    """All 1000 points decode (subgroup check off) and re-encode byte for
    byte; lane 0 is the identity."""
    mod = GROUPS[group][0]
    data = walk(group, form)
    aff, valid = getattr(mod, f"from_{form}_host")(
        data, device="cpu", **{CHECK[form]: False})
    assert valid.all()
    assert aff[2].tolist() == [True] + [False] * 999
    assert np.array_equal(getattr(mod, f"to_{form}_host")(aff), data)


@pytest.mark.parametrize("group,form", [(g, f) for g in GROUPS
                                        for f in FORMS])
def test_walk_with_the_check_and_the_host_oracle(group, form):
    """32 points of the walk with the subgroup check: valid, the same
    points as without it, equal to the host oracle's decoding."""
    mod = GROUPS[group][0]
    data = walk(group, form)[::31][:32]
    aff, valid = getattr(mod, f"from_{form}_host")(data, device="cpu")
    assert valid.all()
    off, _ = getattr(mod, f"from_{form}_host")(data, device="cpu",
                                               **{CHECK[form]: False})
    assert all(torch.equal(a, b) for a, b in zip(scans.tree_leaves(aff),
                                                 scans.tree_leaves(off)))
    dec = getattr(hm, f"{group}_from_{form}")
    assert port_cases.affine_to_host(group, aff) == [dec(bytes(r))
                                                    for r in data]


def probe_bytes(group: str, form: str):
    """(encodings uint8 [n, width], labels): G, 2G, the identity, a point
    outside the subgroup, then every reject of `port_cases.reject_cases`."""
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
    mul = {"g1": hm.g1_mul, "g2": hm.g2_mul}[group]
    bad = {"g1": hm.g1_point_outside_subgroup,
           "g2": hm.g2_point_outside_subgroup}[group]()
    enc = getattr(hm, f"{group}_to_{form}")
    labels = ["G", "2G", "identity", "outside the subgroup"]
    rows = [enc(gen), enc(mul(gen, 2)), enc(None), enc(bad)]
    for label, c in port_cases.reject_cases(group, form):
        labels.append(label)
        rows.append(c)
    return np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), -1), \
        labels


@pytest.mark.parametrize("check", [True, False])
@pytest.mark.parametrize("group,form", [(g, f) for g in GROUPS
                                        for f in FORMS])
def test_decoders_match_jax_on_probes(group, form, check):
    """The port's decoders against the JAX package's on valid points, a
    point outside the subgroup and the flag-bit rejects: the same affine
    limbs on every lane and the same valid mask; the mask is the host
    oracle's verdict (ValueError = invalid)."""
    mod, jmod = GROUPS[group]
    data, labels = probe_bytes(group, form)
    kw = {CHECK[form]: check}
    aff, valid = getattr(mod, f"from_{form}_host")(data, device="cpu", **kw)
    jaff, jvalid = getattr(jmod, f"from_{form}_host")(data, **kw)
    assert np.array_equal(valid, np.asarray(jvalid))
    assert same_points(aff, jaff)
    dec = getattr(jhm, f"{group}_from_{form}")
    oracle = []
    for r in data:
        try:
            dec(bytes(r), check)
            oracle.append(True)
        except ValueError:
            oracle.append(False)
    assert valid.tolist() == oracle
    assert valid.tolist()[:4] == [True, True, True, not check], labels


@pytest.mark.parametrize("group,form", [(g, f) for g in GROUPS
                                        for f in FORMS])
def test_encoders_match_jax(group, form):
    """to_compressed_host / to_uncompressed_host of affine batches with an
    identity lane against the JAX package's encoders and hostmath's."""
    mod, jmod = GROUPS[group]
    data, _ = probe_bytes(group, form)
    aff, _ = getattr(mod, f"from_{form}_host")(data[:3], device="cpu")
    jaff, _ = getattr(jmod, f"from_{form}_host")(data[:3])
    got = getattr(mod, f"to_{form}_host")(aff)
    assert np.array_equal(got, getattr(jmod, f"to_{form}_host")(jaff))
    assert np.array_equal(got, data[:3])


@pytest.mark.parametrize("group,form", [(g, f) for g in GROUPS
                                        for f in FORMS])
def test_infinity_round_trips(group, form):
    """0xc0 00.. (compressed) and 0x40 00.. (uncompressed) decode to the
    identity, valid, and encode back."""
    mod = GROUPS[group][0]
    width = {"g1": 48, "g2": 96}[group] * (1 if form == "compressed" else 2)
    data = np.zeros((2, width), np.uint8)
    data[:, 0] = 0xC0 if form == "compressed" else 0x40
    aff, valid = getattr(mod, f"from_{form}_host")(data, device="cpu")
    assert valid.all() and aff[2].all()
    assert np.array_equal(getattr(mod, f"to_{form}_host")(aff), data)


@pytest.mark.parametrize("group,form", [(g, f) for g in GROUPS
                                        for f in FORMS])
def test_decoders_reject_another_width(group, form):
    """Encodings one byte short or long raise ValueError (the JAX decoders
    would read whatever lies in the first bytes)."""
    mod = GROUPS[group][0]
    width = {"g1": 48, "g2": 96}[group] * (1 if form == "compressed" else 2)
    for n in (width - 1, width + 1):
        with pytest.raises(ValueError, match=f"encodings of {width} bytes"):
            getattr(mod, f"from_{form}_host")(np.zeros((2, n), np.uint8),
                                              device="cpu")
