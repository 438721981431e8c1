"""Batched hash to curve (draft-irtf-cfrg-hash-to-curve-16) on the device.

Counterpart of `bls12_381_tpu/hash_to_curve/h2c.py`, with its split:
message expansion by hashlib on the host (`hostmath`), or with
`expand="device"` by `kernels/sha256.py`'s expand_message_xmd (equal-
length messages: one launch of the XMD kernel, `csrc/sha256.cu`, on the
card; its plain version on the CPU); from hash_to_field's reduction
onward (simplified SWU, the isogeny, cofactor clearing) everything is
batched on the device.
Host inputs go to `device` (the card by default).

One departure keeps every lane's value: `hash_to_curve_*` maps u0 and u1
as ONE batch of 2B lanes (u as [L, 2, B]) and then adds the two halves,
where the JAX package maps them in two calls; so each launch of the map
serves both.

Spans (`utils/profiling.py`): `h2c` over each hash_to_curve_* and
encode_to_curve_*, `h2c.map` over the map (SSWU and the isogeny), `h2c.clear`
over the cofactor clearing.

Reference anchors: src/hash_to_curve/{mod,expand_msg,map_g1,map_g2}.rs.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as hm
from .. import params
from ..curves import g1 as G1
from ..curves import g2 as G2
from ..fields import fp, fr, tower as tw
from ..kernels import sha256
from ..utils import profiling, scans

# isogeny and SSWU constants (draft-16 appendix E; canonical ints)
_C = params.ISO_CONSTS


# ---------------------------------------------------------------------------
# hash_to_field: expansion on the host or the device, arithmetic batched
# ---------------------------------------------------------------------------


def hash_to_field_fp(msgs, dst, count, expand=hm.expand_message_xmd,
                     device="cuda", **kw):
    """msgs: list of bytes -> Fp batch [L, count, len(msgs)] (Montgomery),
    expanded on the host by `expand` (keywords `kw`)."""
    vals = [hm.hash_to_field_fp(m, dst, count, expand, **kw) for m in msgs]
    return fp.from_ints(np.array(vals, dtype=object).T, device=device)


def hash_to_field_fp2(msgs, dst, count, expand=hm.expand_message_xmd,
                      device="cuda", **kw):
    """msgs: list of bytes -> Fp2 batch ([L, count, n], [L, count, n])."""
    vals = [hm.hash_to_field_fp2(m, dst, count, expand, **kw) for m in msgs]
    arr = np.array(vals, dtype=object)  # [n, count, 2]
    return (fp.from_ints(arr[..., 0].T, device=device),
            fp.from_ints(arr[..., 1].T, device=device))


def hash_to_field_fr(msgs, dst, count, expand=hm.expand_message_xmd,
                     device="cuda", **kw):
    """HashToField for Scalar (map_scalar.rs:10-23): 48 bytes per element,
    host expansion -> Fr batch [L, count, n] (Montgomery)."""
    vals = [hm.hash_to_field_fr(m, dst, count, expand, **kw) for m in msgs]
    return fr.from_ints(np.array(vals, dtype=object).T, device=device)


def hash_to_field_fp_device(msgs, dst, count, device="cuda"):
    """hash_to_field on the device: batched SHA-256 XMD expansion and
    `fp.from_okm`.  msgs: equal-length list of bytes, or uint8 [B, len]
    (a tensor stays on its device).  Returns Fp [L, count, B]."""
    okm = sha256.expand_message_xmd_sha256(msgs, dst, count * 64, device)
    u = fp.from_okm(okm.reshape(okm.shape[0], count, 64))  # [L, B, count]
    return u.movedim(-1, 1)


def hash_to_field_fp2_device(msgs, dst, count, device="cuda"):
    """hash_to_field over Fp2 on the device (map_g2.rs:367-379: 128 bytes
    per element, c0 from the first 64, c1 from the last).  Returns
    ([L, count, B], [L, count, B])."""
    okm = sha256.expand_message_xmd_sha256(msgs, dst, count * 128, device)
    u = fp.from_okm(okm.reshape(okm.shape[0], count, 2, 64))  # [L,B,count,2]
    return u[..., 0].movedim(-1, 1), u[..., 1].movedim(-1, 1)


def hash_to_field_fr_device(msgs, dst, count, device="cuda"):
    """Scalar hash_to_field on the device: SHA-256 XMD expansion and the
    wide reduction (`fr.from_okm`).  Returns Fr [L, count, B]."""
    okm = sha256.expand_message_xmd_sha256(msgs, dst, count * 48, device)
    return fr.from_okm(okm.reshape(okm.shape[0], count, 48)).movedim(-1, 1)


# ---------------------------------------------------------------------------
# Simplified SWU (batched, both branches computed and mask-selected)
# ---------------------------------------------------------------------------


def _sswu(u, f, consts):
    """Batched SSWU onto y^2 = x^3 + A x + B (draft-16 F.2) over the field
    ops `f`; `consts` holds A, B, Z and one.  Returns affine (x, y) with
    sgn0(y) == sgn0(u).  u = 0 (tv = 0) takes the exceptional
    x1den = Z A."""
    A, B, Z, one = consts["A"], consts["B"], consts["Z"], consts["one"]
    usq = f["sqr"](u)
    z_usq = f["mul"](Z, usq)
    zz_u4 = f["sqr"](z_usq)
    tv = f["add"](zz_u4, z_usq)
    x1num = f["mul"](B, f["add"](tv, one))
    x1den = f["select"](f["is_zero"](tv), f["mul"](Z, A),
                        f["mul"](A, f["neg"](tv)))
    # g(x1) as a fraction over x1den^3
    dsq = f["sqr"](x1den)
    dcb = f["mul"](dsq, x1den)
    gnum = f["add"](f["add"](f["mul"](f["sqr"](x1num), x1num),
                             f["mul"](f["mul"](A, x1num), dsq)),
                    f["mul"](B, dcb))
    g1v = f["mul"](gnum, f["inv"](dcb))
    y1, ok1 = f["sqrt"](g1v)
    # the second candidate x2 = Z u^2 x1, g(x2) = g(x1) Z^3 u^6
    zu3 = f["mul"](f["sqr"](z_usq), z_usq)
    y2, _ = f["sqrt"](f["mul"](g1v, zu3))
    x_num = f["select"](ok1, x1num, f["mul"](z_usq, x1num))
    y = f["select"](ok1, y1, y2)
    x = f["mul"](x_num, f["inv"](x1den))
    flip = f["sgn0"](y) != f["sgn0"](u)
    return x, f["select"](flip, f["neg"](y), y)


def _horner(coeffs, x, f):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = f["add"](f["mul"](acc, x), c)
    return acc


_FP_NS = dict(
    add=fp.add, neg=fp.neg, mul=fp.mul, sqr=fp.sqr, inv=fp.inv,
    sqrt=fp.sqrt, select=fp.select, is_zero=fp.is_zero,
    sgn0=lambda a: fp.sgn0_mont(a) != 0,
)
_FP2_NS = dict(
    add=tw.fp2_add, neg=tw.fp2_neg, mul=tw.fp2_mul, sqr=tw.fp2_sqr,
    inv=tw.fp2_inv, sqrt=tw.fp2_sqrt, select=tw.fp2_select,
    is_zero=tw.fp2_is_zero, sgn0=tw.fp2_sgn0,
)


def _iso_map(x, y, const, f, name):
    """The isogeny's rational maps at (x, y), projectively:
    (xn yd : y yn xd : xd yd) with xn / xd and yn / yd by Horner."""
    xn, xd, yn, yd = (_horner([const(c) for c in _C[f"{name}_{part}"]], x, f)
                      for part in ("xnum", "xden", "ynum", "yden"))
    return f["mul"](xn, yd), f["mul"](f["mul"](y, yn), xd), f["mul"](xd, yd)


@profiling.spanned("h2c.map")
def map_to_curve_g1(u):
    """SSWU to iso-E1, then the 11-isogeny to E1 (map_g1.rs:545-630):
    Fp [L, *batch] -> projective G1."""
    batch, dev = u.shape[1:], u.device

    def const(c):
        return fp.const(c, batch, device=dev)

    x, y = _sswu(u, _FP_NS, dict(A=const(_C["g1_sswu_a"]),
                                 B=const(_C["g1_sswu_b"]),
                                 Z=const(_C["g1_sswu_xi"]), one=const(1)))
    return _iso_map(x, y, const, _FP_NS, "iso11")


@profiling.spanned("h2c.map")
def map_to_curve_g2(u):
    """SSWU to iso-E2, then the 3-isogeny to E2 (map_g2.rs:391-492): Fp2
    [L, *batch] -> projective G2."""
    batch, dev = u[0].shape[1:], u[0].device

    def const(c):
        return tw.fp2_const(c, batch, dev)

    x, y = _sswu(u, _FP2_NS, dict(A=const(_C["g2_sswu_a"]),
                                  B=const(_C["g2_sswu_b"]),
                                  Z=const(_C["g2_sswu_xi"]),
                                  one=const((1, 0))))
    return _iso_map(x, y, const, _FP2_NS, "iso3")


# ---------------------------------------------------------------------------
# hash_to_curve and encode_to_curve
# ---------------------------------------------------------------------------


def _field(fp2: bool, msgs, dst, count, expand, device, kw):
    """u [L, count, B] (Fp) or its Fp2 pair, expanded on the host by
    `expand` or, for expand == "device", on the device."""
    if expand == "device":
        fn = hash_to_field_fp2_device if fp2 else hash_to_field_fp_device
        return fn(msgs, dst, count, device)
    fn = hash_to_field_fp2 if fp2 else hash_to_field_fp
    return fn(msgs, dst, count, expand, device, **kw)


def _clear(curve, q):
    """The cofactor clearing of a mapped point: the span `h2c.clear`."""
    with profiling.span("h2c.clear"):
        return curve.clear_cofactor(q)


def _halves(q):
    """A point over the batch (2, B) -> its two [B] halves."""
    return (scans.tree_map(lambda t: t[:, 0], q),
            scans.tree_map(lambda t: t[:, 1], q))


@profiling.spanned("h2c")
def hash_to_curve_g1(msgs, dst, expand=hm.expand_message_xmd, device="cuda",
                     **kw):
    """Batched hash_to_curve: messages -> projective G1 batch [B].
    expand="device" expands with the device SHA-256 (equal-length
    messages)."""
    u = _field(False, msgs, dst, 2, expand, device, kw)
    return _clear(G1, G1.add(*_halves(map_to_curve_g1(u))))


@profiling.spanned("h2c")
def encode_to_curve_g1(msgs, dst, expand=hm.expand_message_xmd,
                       device="cuda", **kw):
    u = _field(False, msgs, dst, 1, expand, device, kw)
    return _clear(G1, map_to_curve_g1(u[:, 0]))


@profiling.spanned("h2c")
def hash_to_curve_g2(msgs, dst, expand=hm.expand_message_xmd, device="cuda",
                     **kw):
    u = _field(True, msgs, dst, 2, expand, device, kw)
    return _clear(G2, G2.add(*_halves(map_to_curve_g2(u))))


@profiling.spanned("h2c")
def encode_to_curve_g2(msgs, dst, expand=hm.expand_message_xmd,
                       device="cuda", **kw):
    u = _field(True, msgs, dst, 1, expand, device, kw)
    return _clear(G2, map_to_curve_g2((u[0][:, 0], u[1][:, 0])))
