"""The port's native host runtime (`bls12_381_torch/utils/native.py` over
`utils/csrc/bls_host.cpp`, built here with the host C++ compiler) against
`hostmath` and the port's own encoders: the batched Fp byte codecs with and
without the Montgomery conversion, and expand_message_xmd over SHA-256
(empty message, empty DST, an oversize DST, lengths up to the largest).
A build that fails raises, with nothing to fall back on.

Tolerance: none (bytes and limbs compare exactly).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest
from bls12_381_torch import convert, hostmath as hm
from bls12_381_torch.fields import fp
from bls12_381_torch.params import P
from bls12_381_torch.utils import native

np_rng = np.random.RandomState(20261020)
ROOT = conftest.VECTORS.parent.parent


def fp_rows(n: int) -> list[int]:
    """n big-endian Fp rows: 0, 1, p - 1, p, p + 1, 2^381 - 1, 2^384 - 1,
    then random 381-bit values (about a fifth of them >= p)."""
    edges = [0, 1, P - 1, P, P + 1, (1 << 381) - 1, (1 << 384) - 1]
    rand = [int.from_bytes(np_rng.randint(0, 256, 48).astype(np.uint8)
                           .tobytes(), "big") % (P + P // 4)
            for _ in range(n - len(edges))]
    return edges + rand


def as_bytes(values) -> np.ndarray:
    return np.frombuffer(b"".join(v.to_bytes(48, "big") for v in values),
                         np.uint8).reshape(-1, 48)


def test_library_builds_into_the_build_directory():
    assert native.available()
    lib = native._load()
    assert os.path.dirname(lib._name) == str(ROOT / "bls12_381_torch"
                                             / "kernels" / "_build")


@pytest.mark.parametrize("to_mont", [True, False])
def test_fp_from_bytes_matches_hostmath(to_mont):
    """64 rows: the mask is hostmath's (p and p + 1 rejected), the limbs
    those of fp.from_ints (Montgomery or raw) on the canonical rows and of
    0 elsewhere, and convert / from_bytes_host agree."""
    values = fp_rows(64)
    data = as_bytes(values)
    got, ok = native.fp_from_bytes(data, to_mont=to_mont)
    assert got.dtype == np.uint32 and got.shape == (24, 64)
    want_ok = [hm.fp_from_bytes(bytes(r)) is not None for r in data]
    assert ok.tolist() == want_ok
    assert ok[:3].all() and not ok[3:7].any()
    canon = [v if o else 0 for v, o in zip(values, want_ok)]
    want = fp.from_ints(canon, to_mont=to_mont, device="cpu")
    assert torch.equal(convert.fp_to_torch(got, device="cpu"), want)
    if to_mont:
        dev, dev_ok = fp.from_bytes_host(data, device="cpu")
        assert dev_ok.tolist() == want_ok
        assert torch.equal(dev[:, dev_ok], want[:, dev_ok])


@pytest.mark.parametrize("from_mont", [True, False])
def test_fp_to_bytes_matches_hostmath(from_mont):
    values = [v for v in fp_rows(64) if v < P]
    limbs_in = fp.from_ints(values, to_mont=from_mont, device="cpu")
    got = native.fp_to_bytes(convert.fp_from_torch(limbs_in),
                             from_mont=from_mont)
    assert got.shape == (len(values), 48)
    assert [bytes(r) for r in got] == [hm.fp_to_bytes(v) for v in values]
    if from_mont:
        assert np.array_equal(got, fp.to_bytes_host(limbs_in))
        back, ok = native.fp_from_bytes(got)
        assert ok.all() and np.array_equal(back, convert.fp_from_torch(
            limbs_in))


MSGS = [b"", b"abc", bytes(range(55)), bytes(range(56)), bytes(64),
        bytes(np_rng.randint(0, 256, 100).astype(np.uint8)),
        b"q128_" + b"q" * 128, bytes(np_rng.randint(0, 256, 600)
                                     .astype(np.uint8))]


@pytest.mark.parametrize("dst", [
    b"QUUX-V01-CS02-with-expander-SHA256-128", b"", b"y" * 255,
    bytes(np_rng.randint(0, 256, 300).astype(np.uint8))],
    ids=["kat-dst", "empty-dst", "dst-255", "dst-300"])
@pytest.mark.parametrize("length", [32, 128, 8160])
def test_expand_message_xmd_matches_hostmath(dst, length):
    """Eight messages of mixed lengths (the empty one first) in one call;
    a DST over 255 bytes is hashed first, as hostmath does."""
    got = native.expand_message_xmd_sha256(MSGS, dst, length)
    assert got.shape == (len(MSGS), length)
    assert [bytes(r) for r in got] == [hm.expand_message_xmd(m, dst, length)
                                       for m in MSGS]


def test_codec_shapes_are_checked():
    """A row width the C functions do not read is refused before any
    pointer is passed."""
    for bad in (np.zeros((4, 47), np.uint8), np.zeros(48, np.uint8)):
        with pytest.raises(ValueError, match="48"):
            native.fp_from_bytes(bad)
    with pytest.raises(ValueError, match="24"):
        native.fp_to_bytes(np.zeros((16, 4), np.uint32))


def test_expand_message_xmd_edges():
    assert native.expand_message_xmd_sha256([], b"dst", 32).shape == (0, 32)
    with pytest.raises(ValueError):
        native.expand_message_xmd_sha256(MSGS, b"dst", 8161)
    with pytest.raises(ValueError):
        hm.expand_message_xmd(b"", b"dst", 8161)


@pytest.mark.parametrize("cxx,marker", [
    ("false", "exit 1"),
    ("sh -c 'echo compiler-said-no >&2; exit 3' --", "compiler-said-no")])
def test_failed_build_raises(tmp_path, cxx, marker):
    """With a compiler that fails (CXX=false, or one that prints an error),
    available() is false and every function raises RuntimeError carrying
    the compiler's exit and output."""
    script = (
        "import numpy as np\n"
        "from bls12_381_torch.utils import native\n"
        "assert not native.available()\n"
        "calls = [lambda: native.fp_from_bytes(np.zeros((1, 48), np.uint8)),\n"
        "         lambda: native.fp_to_bytes(np.zeros((24, 1), np.uint32)),\n"
        "         lambda: native.expand_message_xmd_sha256([b''], b'd', 32)]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as exc:\n"
        f"        assert {marker!r} in str(exc), exc\n"
        "    else:\n"
        "        raise AssertionError('no RuntimeError')\n"
        "print('raised')\n")
    env = dict(os.environ, CXX=cxx, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"
