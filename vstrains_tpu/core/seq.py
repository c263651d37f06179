"""DNA sequence primitives: 2-bit-style encoding, reverse complement, rolling
window hashes.

Design notes
------------
Node/read sequences are encoded to small-integer code arrays (A,C,G,T -> 0..3,
anything else -> BAD_CODE) so that k-mer extraction and matching become integer
tensor ops.  Exact (k+1)-mer identity is represented by a pair of independent
32-bit polynomial window hashes (two lanes, odd multipliers, natural uint32
wrap-around) — 64 bits of discrimination without 64-bit integer ops (JAX runs
without x64 by default).  The same hash function runs:
  * on host (numpy, table construction over graph node sequences), and
  * on device (jnp, the per-read-batch probe kernel in ops/pe_infer.py).

Replaces the reference's Python string k-mer dictionary
(/root/reference/utils/VStrains_PE_Inference.py:114-135) and string
reverse-complement (/root/reference/utils/VStrains_Utilities.py:1015-1016).
"""

from __future__ import annotations

import numpy as np

BAD_CODE = np.uint8(255)

# Two independent odd multipliers for the two 32-bit hash lanes.
HASH_MULT_1 = np.uint32(0x9E3779B1)
HASH_MULT_2 = np.uint32(0x85EBCA77)

_ENC = np.full(256, BAD_CODE, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENC[_b] = _i

_DEC = np.frombuffer(b"ACGT", dtype=np.uint8)

_RC_TABLE = {
    "A": "T", "T": "A", "C": "G", "G": "C",
    "a": "t", "t": "a", "c": "g", "g": "c",
}


def encode_seq(seq) -> np.ndarray:
    """Encode a DNA string (or bytes) to uint8 codes; non-ACGT -> BAD_CODE.

    Lowercase bases (the reference lowercases self-loop segments,
    VStrains_IO.py:117-119) and Ns map to BAD_CODE: windows containing them
    never match any read k-mer, mirroring the reference where lowercase node
    k-mers cannot equal uppercase read k-mers.
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENC[np.frombuffer(seq, dtype=np.uint8)]


def decode_codes(codes: np.ndarray) -> str:
    """Decode 0..3 codes back to an ACGT string (BAD_CODE -> 'N')."""
    out = np.full(codes.shape, ord("N"), dtype=np.uint8)
    ok = codes < 4
    out[ok] = _DEC[codes[ok]]
    return out.tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement in code space; BAD_CODE stays bad."""
    out = np.where(codes < 4, 3 - codes, BAD_CODE).astype(np.uint8)
    return out[::-1]


def revcomp_str(seq: str) -> str:
    """Reverse complement of a DNA string (unknown chars -> N).

    Parity with /root/reference/utils/VStrains_Utilities.py:1015-1016 on ACGT
    input, lenient elsewhere.
    """
    return "".join(_RC_TABLE.get(ch, "N") for ch in reversed(seq))


def _mult_pows(mult: np.uint32, n: int) -> np.ndarray:
    """[mult^0, mult^1, ..., mult^(n-1)] mod 2^32.

    Vectorized doubling — pows[step + i] = pows[i] * mult^step — instead
    of an n-iteration Python loop (which dominated table builds at
    metaSPAdes scale). uint32 multiply wraps mod 2^32 exactly, so the
    values are bit-identical to the sequential product."""
    pows = np.empty(n, dtype=np.uint32)
    if n == 0:
        return pows
    pows[0] = 1
    step = 1
    with np.errstate(over="ignore"):
        while step < n:
            cnt = min(step, n - step)
            f = np.uint32(pow(int(mult), step, 1 << 32))
            np.multiply(pows[:cnt], f, out=pows[step:step + cnt])
            step *= 2
    return pows


def _mult_inverse(mult: np.uint32) -> int:
    """Multiplicative inverse of an odd multiplier mod 2^32 (Newton)."""
    m = int(mult)
    x = m  # correct mod 2^3; each step doubles the valid bits
    for _ in range(5):
        x = (x * (2 - m * x)) & 0xFFFFFFFF
    assert (x * m) & 0xFFFFFFFF == 1
    return x


def _inv_pows(mult: np.uint32, n: int) -> np.ndarray:
    """[M^0, M^-1, ..., M^-(n-1)] mod 2^32."""
    return _mult_pows(np.uint32(_mult_inverse(mult)), n)


_PREFIX_WEIGHTS_CACHE: dict = {}
_PREFIX_WEIGHTS_CACHE_MAX_T = 64 * 1024 * 1024


def prefix_hash_weights(L: int, T: int):
    """Host-precomputed weight tables for the prefix-sum window hash.

    For each lane: position weights w[i] = M^-i (length T) and window
    scales s[j] = M^(j+L-1) (length T - L + 1).  With
    P[j] = sum_{i<j} c[i] * w[i]  (prefix sums mod 2^32),
    the window hash  h[j] = sum_t c[j+t] * M^(L-1-t)  factors exactly as
    (P[j+L] - P[j]) * s[j]:  one cumsum + one subtraction + one multiply
    replaces the L-term inner loop — O(T) instead of O(L*(T-L)) per
    sequence, bit-identical mod 2^32.

    Both tables are position-prefixes of the infinite power series, so
    one cached table per L serves every T <= its length via views
    (geometric growth on miss). The table build calls this at the full
    concatenation length — without the cache, recomputing the ~10M-term
    power tables per strand cost ~2.5 s at metaSPAdes scale.

    The returned arrays are read-only VIEWS into the cache (mutating a
    result would otherwise corrupt every later hash). Worst-case
    retention: 4 arrays x cap x 4 bytes per distinct L, up to ~1 GB at
    the 64M cap, for process lifetime — acceptable because real
    pipelines use one or two window lengths."""
    K = T - L + 1
    ent = _PREFIX_WEIGHTS_CACHE.get(L)
    if ent is None or ent[0] < T:
        cap_T = T if T > _PREFIX_WEIGHTS_CACHE_MAX_T else max(
            T, 2 * (ent[0] if ent else 0))
        tabs = []
        for mult in (HASH_MULT_1, HASH_MULT_2):
            w = _inv_pows(mult, cap_T)
            pows = _mult_pows(mult, cap_T + L)
            w.setflags(write=False)
            pows.setflags(write=False)
            tabs.append((w, pows))
        ent = (cap_T, tabs)
        # store oversized entries too: an entry built past the cap can
        # still serve every later call (views are cheap); the cap only
        # bounds what geometric DOUBLING may allocate beyond need
        _PREFIX_WEIGHTS_CACHE[L] = ent
    return [(w[:T], pows[L - 1: L - 1 + K]) for w, pows in ent[1]]


def window_hashes_np(codes: np.ndarray, L: int):
    """All length-L window hashes of a code array, host/numpy version.

    Returns (h1, h2, valid): each of shape (len(codes) - L + 1,) — uint32,
    uint32, bool. A window is valid iff it contains no BAD_CODE.

    hash lane: h = sum_i (code[i] + 1) * M^(L-1-i) mod 2^32, computed via
    the prefix-sum factorization (see prefix_hash_weights).
    """
    n = int(codes.shape[0])
    w = n - L + 1
    if w <= 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z.copy(), np.zeros(0, dtype=bool)
    bad = (codes >= 4).astype(np.int32)
    bad_prefix = np.concatenate([[0], np.cumsum(bad)])
    valid = (bad_prefix[L:] - bad_prefix[:-L]) == 0

    c = (np.where(codes < 4, codes, 0).astype(np.uint32) + np.uint32(1))
    out = []
    with np.errstate(over="ignore"):
        for weights, scales in prefix_hash_weights(L, n):
            pref = np.zeros(n + 1, dtype=np.uint32)
            np.cumsum(c * weights, dtype=np.uint32, out=pref[1:])
            out.append((pref[L:] - pref[:-L]) * scales)
    return out[0], out[1], valid


def _window_hashes_np_direct(codes: np.ndarray, L: int):
    """Direct L-term evaluation of the window hash (the definition);
    kept as the oracle for testing the prefix-sum factorization."""
    n = int(codes.shape[0])
    w = n - L + 1
    if w <= 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z.copy(), np.zeros(0, dtype=bool)
    bad = (codes >= 4).astype(np.int32)
    bad_prefix = np.concatenate([[0], np.cumsum(bad)])
    valid = (bad_prefix[L:] - bad_prefix[:-L]) == 0

    c = (np.where(codes < 4, codes, 0).astype(np.uint32) + np.uint32(1))
    out = []
    for mult in (HASH_MULT_1, HASH_MULT_2):
        pows = _mult_pows(mult, L)[::-1].copy()  # M^(L-1) .. M^0
        with np.errstate(over="ignore"):
            h = np.zeros(w, dtype=np.uint32)
            for i in range(L):
                h += c[i : i + w] * pows[i]
        out.append(h)
    return out[0], out[1], valid


def seq_window_hashes(seq: str, L: int):
    """Window hashes of a string sequence (host)."""
    return window_hashes_np(encode_seq(seq), L)
