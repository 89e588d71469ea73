"""Self-contained Ethereum signature primitives for x402 payment verification.

The reference server can only verify payments by POSTing them to an external
facilitator (reference: src/server/src/main.rs:60-79 delegates to the
x402-axum middleware's facilitator client). That makes payment gating
impossible in zero-egress deployments and adds a third party to every
request. This module implements the underlying cryptography from scratch —
keccak-256, secp256k1 ECDSA with RFC-6979 deterministic nonces, EIP-712
typed-data hashing, and ecrecover — so `X402Gate(mode="local")` can verify
EIP-3009 TransferWithAuthorization payloads entirely in-process.

Pure Python, no dependencies beyond hashlib/hmac. Signature verification is
one ecrecover (~2 scalar mults, low single-digit ms with the Jacobian
ladder below) — negligible next to synthesis, and off the device entirely.

Test vectors: tests/test_eth.py pins keccak-256 known answers, the
private-key→address vectors, and the EIP-712 spec's "Mail" example
(sign hash, deterministic signature, and recovery).

The PyTorch port's own copy of smalltts_tpu/serving/eth.py, with its imports
pointing at smalltts_tpu_torch; it behaves as that module does.
"""

from __future__ import annotations

import hashlib
import hmac

# ---------------------------------------------------------------------------
# keccak-256 (the pre-NIST Keccak padding 0x01, NOT sha3_256's 0x06)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y]
_KECCAK_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK64 = (1 << 64) - 1


def _rol64(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK64


def _keccak_f(a: list) -> None:
    """Keccak-f[1600] permutation over a 5x5 lane matrix a[x][y], in place."""
    for rc in _KECCAK_RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol64(a[x][y], _KECCAK_ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        a[0][0] ^= rc


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    a = [[0] * 5 for _ in range(5)]
    # multi-rate pad: 0x01 ... 0x80 (same byte when the block has one slot)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = padded[off:off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8:(i + 1) * 8], "little")
            a[i % 5][i // 5] ^= lane
        _keccak_f(a)
    out = bytearray()
    for i in range(4):  # 32 bytes < rate: single squeeze
        out += a[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)


# ---------------------------------------------------------------------------
# secp256k1
# ---------------------------------------------------------------------------

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# Points are Jacobian (X, Y, Z) with affine (X/Z^2, Y/Z^3); None = infinity.


def _jac_double(pt):
    if pt is None:
        return None
    x, y, z = pt
    if y == 0:
        return None
    s = (4 * x * y * y) % P
    m = (3 * x * x) % P  # a = 0 on secp256k1
    x2 = (m * m - 2 * s) % P
    y2 = (m * (s - x2) - 8 * pow(y, 4, P)) % P
    z2 = (2 * y * z) % P
    return (x2, y2, z2)


def _jac_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    z1s, z2s = (z1 * z1) % P, (z2 * z2) % P
    u1, u2 = (x1 * z2s) % P, (x2 * z1s) % P
    s1, s2 = (y1 * z2s * z2) % P, (y2 * z1s * z1) % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jac_double(p1)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    h2 = (h * h) % P
    h3 = (h * h2) % P
    u1h2 = (u1 * h2) % P
    x3 = (r * r - h3 - 2 * u1h2) % P
    y3 = (r * (u1h2 - x3) - s1 * h3) % P
    z3 = (h * z1 * z2) % P
    return (x3, y3, z3)


def _jac_mul(k: int, pt) -> "tuple | None":
    k %= N
    acc, add = None, pt
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return acc


def _to_affine(pt):
    if pt is None:
        return None
    x, y, z = pt
    zi = pow(z, P - 2, P)
    zi2 = (zi * zi) % P
    return ((x * zi2) % P, (y * zi2 * zi) % P)


_G = (_GX, _GY, 1)


def pubkey(priv: int):
    """Affine public key (x, y) for a private scalar."""
    if not 1 <= priv < N:
        raise ValueError("private key out of range")
    return _to_affine(_jac_mul(priv, _G))


def address_from_pubkey(pub) -> str:
    x, y = pub
    h = keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))
    return checksum_address("0x" + h[12:].hex())


def address_from_priv(priv: int) -> str:
    return address_from_pubkey(pubkey(priv))


def checksum_address(addr: str) -> str:
    """EIP-55 mixed-case checksum encoding."""
    raw = addr.lower().replace("0x", "")
    digest = keccak256(raw.encode()).hex()
    out = "".join(
        c.upper() if c.isalpha() and int(digest[i], 16) >= 8 else c
        for i, c in enumerate(raw)
    )
    return "0x" + out


def _rfc6979_k_stream(priv: int, msg_hash: bytes):
    """Deterministic nonce candidates per RFC 6979 with HMAC-SHA256 (the
    construction ethereum tooling uses, so signatures are bit-reproducible
    across stacks). A generator: RFC 6979 §3.2 step h retries a rejected k
    (r==0 or s==0 in the caller) by CONTINUING the HMAC-DRBG stream — the
    first cut re-hashed msg_hash instead, which would have signed the wrong
    message had the ~2^-256 retry ever fired."""
    x = priv.to_bytes(32, "big")
    h1 = (int.from_bytes(msg_hash, "big") % N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            yield cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


def sign_hash(priv: int, msg_hash: bytes) -> bytes:
    """ECDSA over a 32-byte hash -> 65-byte r||s||v signature (v in {27,28}),
    low-s normalized (EIP-2), deterministic k (RFC 6979)."""
    z = int.from_bytes(msg_hash, "big")
    for k in _rfc6979_k_stream(priv, msg_hash):
        rx, ry = _to_affine(_jac_mul(k, _G))
        r = rx % N
        if r == 0:
            continue  # next DRBG candidate (RFC 6979 §3.2 h.3)
        s = (pow(k, N - 2, N) * (z + r * priv)) % N
        if s == 0:
            continue
        recid = (ry & 1) | (2 if rx >= N else 0)
        if s > N // 2:
            s = N - s
            recid ^= 1
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([27 + recid])


def ecrecover(msg_hash: bytes, sig: bytes) -> str:
    """Recover the EIP-55 signer address from a 65-byte r||s||v signature.
    Raises ValueError on malformed or unrecoverable signatures."""
    if len(sig) != 65:
        raise ValueError("signature must be 65 bytes")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    if v in (0, 1):  # some stacks emit raw recid
        v += 27
    if v not in (27, 28, 29, 30):
        raise ValueError(f"bad recovery id {v}")
    if not (1 <= r < N and 1 <= s < N):
        raise ValueError("r/s out of range")
    recid = v - 27
    x = r + (recid >> 1) * N
    if x >= P:
        raise ValueError("r overflows field")
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if (y * y) % P != y_sq:
        raise ValueError("point not on curve")
    if (y & 1) != (recid & 1):
        y = P - y
    z = int.from_bytes(msg_hash, "big")
    rinv = pow(r, N - 2, N)
    q = _jac_add(
        _jac_mul((-z * rinv) % N, _G),
        _jac_mul((s * rinv) % N, (x, y, 1)),
    )
    if q is None:
        raise ValueError("recovered point at infinity")
    return address_from_pubkey(_to_affine(q))


# ---------------------------------------------------------------------------
# EIP-712 typed-data hashing
# ---------------------------------------------------------------------------
# Supports the type system the x402 "exact" scheme and the EIP-712 spec
# examples use: atomic uint*/bytes32/address/bool/string/bytes plus nested
# struct references (with the alphabetically-sorted transitive type closure
# the spec mandates for encodeType).


def _encode_type(primary: str, types: dict) -> bytes:
    deps = set()

    def collect(name):
        for field in types.get(name, []):
            base = field["type"].rstrip("[]")
            if base in types and base not in deps and base != primary:
                deps.add(base)
                collect(base)

    collect(primary)

    def one(name):
        fields = ",".join(f"{f['type']} {f['name']}" for f in types[name])
        return f"{name}({fields})"

    return (one(primary) + "".join(one(d) for d in sorted(deps))).encode()


def _encode_value(ftype: str, value, types: dict) -> bytes:
    if ftype in types:
        return hash_struct(ftype, value, types)
    if ftype == "string":
        return keccak256(str(value).encode())
    if ftype == "bytes":
        return keccak256(_hexbytes(value))
    if ftype == "address":
        return int(str(value), 16).to_bytes(32, "big")
    if ftype == "bool":
        return (1 if value else 0).to_bytes(32, "big")
    if ftype.startswith("uint") or ftype.startswith("int"):
        # NOT base 0: a spec-valid decimal string with a leading zero
        # ("0100") raises in base 0, and "0b1"/"0o7" would misparse —
        # typed-data integers are decimal unless 0x-prefixed
        s = str(value)
        num = int(s, 16) if s.startswith(("0x", "0X")) else int(s)
        return (num % (1 << 256)).to_bytes(32, "big")
    if ftype.startswith("bytes"):  # bytesN, right-padded
        raw = _hexbytes(value)
        if len(raw) > 32:
            raise ValueError(f"{ftype} value too long")
        return raw.ljust(32, b"\x00")
    raise ValueError(f"unsupported EIP-712 type {ftype!r}")


def _hexbytes(value) -> bytes:
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    s = str(value)
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def hash_struct(primary: str, data: dict, types: dict) -> bytes:
    enc = keccak256(_encode_type(primary, types))
    for field in types[primary]:
        enc += _encode_value(field["type"], data[field["name"]], types)
    return keccak256(enc)


def typed_data_hash(typed: dict) -> bytes:
    """The eth_signTypedData_v4 sign hash:
    keccak256(0x1901 || domainSeparator || hashStruct(message))."""
    types = typed["types"]
    domain = hash_struct("EIP712Domain", typed["domain"], types)
    if typed["primaryType"] == "EIP712Domain":
        return keccak256(b"\x19\x01" + domain)
    message = hash_struct(typed["primaryType"], typed["message"], types)
    return keccak256(b"\x19\x01" + domain + message)


def sign_typed_data(priv: int, typed: dict) -> str:
    """0x-hex 65-byte signature over the typed-data sign hash."""
    return "0x" + sign_hash(priv, typed_data_hash(typed)).hex()


def recover_typed_data(typed: dict, signature: str) -> str:
    sig = _hexbytes(signature)
    return ecrecover(typed_data_hash(typed), sig)
