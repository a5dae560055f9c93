"""Carried from olavm_tpu/runtime/ecdsa.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

secp256k1 ECDSA verification for the SIGCHECK opcode.

Pure-Python replacement for the reference's secp256k1-crate call
(executor/src/ecdsa.rs:5-38): each of x, y, r, s, msg is four Goldilocks
elements packed big-endian (8 bytes each) into a 32-byte big-endian integer.
"""

from __future__ import annotations

# secp256k1 domain parameters
_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _tree_value_to_int(v) -> int:
    out = 0
    for limb in v:
        out = (out << 64) | int(limb)
    return out


def _inv_mod(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _point_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2 and (y1 + y2) % _P == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * _inv_mod(2 * y1, _P) % _P
    else:
        lam = (y2 - y1) * _inv_mod(x2 - x1, _P) % _P
    x3 = (lam * lam - x1 - x2) % _P
    y3 = (lam * (x1 - x3) - y1) % _P
    return (x3, y3)


def _point_mul(k: int, point):
    result = None
    addend = point
    while k:
        if k & 1:
            result = _point_add(result, addend)
        addend = _point_add(addend, addend)
        k >>= 1
    return result


def _on_curve(x: int, y: int) -> bool:
    return (y * y - (x * x * x + 7)) % _P == 0


def ecdsa_verify(pk_x, pk_y, sig_r, sig_s, msg) -> bool:
    x = _tree_value_to_int(pk_x)
    y = _tree_value_to_int(pk_y)
    r = _tree_value_to_int(sig_r)
    s = _tree_value_to_int(sig_s)
    z = _tree_value_to_int(msg)

    if not (0 < r < _N and 0 < s < _N):
        return False
    if x >= _P or y >= _P or not _on_curve(x, y):
        return False
    # libsecp256k1 rejects high-s signatures (BIP-62 normalization)
    if s > _N // 2:
        return False
    w = _inv_mod(s, _N)
    u1 = (z * w) % _N
    u2 = (r * w) % _N
    pt = _point_add(_point_mul(u1, (_GX, _GY)), _point_mul(u2, (x, y)))
    if pt is None:
        return False
    return pt[0] % _N == r
