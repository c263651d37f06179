#!/usr/bin/env python3
"""Three-way split of the 116 ms sat tail at the production 50k shape:

  sort       the packed (B2, R) row-sort alone
  nogather   full tail but ref lengths CONSTANT (no 9.3M-element
             seq_lens gather) — timing-only variant
  full       the production tail

If (full - nogather) dominates, the seq_lens gather is the lever; if
nogather ~ full and both >> sort, it's the scan/compact machinery.

Env: PROF_NODES, PROF_BS, PROF_REPS.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    n_nodes = int(os.environ.get("PROF_NODES", 50_000))
    B2 = 2 * int(os.environ.get("PROF_BS", 16384))
    reps = int(os.environ.get("PROF_REPS", 16))
    K, depth = 95, 3
    R = K * depth
    kbits = 7
    cap = 16
    split_len = 56
    from vstrains_tpu.ops.pe_infer import _INF, _sparse_sat_tail

    rng = np.random.default_rng(0)
    node = rng.integers(0, n_nodes, (B2, R)).astype(np.int32)
    kidx = (np.arange(R)[None, :] // depth).astype(np.int32)
    kidx = np.broadcast_to(kidx, (B2, R))
    miss = rng.random((B2, R)) < 0.55
    node_key = np.where(miss, _INF, node).astype(np.int32)
    kidx_v = np.where(miss, _INF, kidx).astype(np.int32)
    nk = jax.device_put(node_key)
    kv = jax.device_put(kidx_v)
    lens = jax.device_put(
        rng.integers(120, 151, B2).astype(np.int32))
    seq_lens = jax.device_put(
        rng.integers(150, 250, n_nodes).astype(np.int32))
    jax.block_until_ready((nk, kv, lens, seq_lens))

    @jax.jit
    def v_sort(nk, kv, salt):
        v = jnp.where(nk == _INF, _INF, (nk << kbits) | kv) + salt - salt
        return jax.lax.sort(v, dimension=1).astype(jnp.int64).sum()

    @jax.jit
    def v_full(nk, kv, lens, seq_lens, salt):
        out, ovf, counts = _sparse_sat_tail(
            nk + salt - salt, kv, lens, seq_lens, split_len, cap,
            kmax=K)
        return (out.astype(jnp.int64).sum() + counts.sum()
                + ovf.astype(jnp.int32))

    @jax.jit
    def v_nogather(nk, kv, lens, salt):
        # inlined tail with ref = 200 constant (timing only)
        v = jnp.where(nk == _INF, _INF, (nk << kbits) | kv) + salt - salt
        kmask = jnp.int32((1 << kbits) - 1)
        v_s = jax.lax.sort(v, dimension=1)
        node_s = jnp.where(v_s == _INF, _INF, v_s >> kbits)
        kidx_s = v_s & kmask
        prev = jnp.concatenate(
            [jnp.full((B2, 1), -1, jnp.int32), node_s[:, :-1]], axis=1)
        startf = node_s != prev
        pos = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 1)
        sv = jnp.where(startf, (pos << kbits) | kidx_s, -1)
        ps = jax.lax.cummax(sv, axis=1)
        startpos = ps >> kbits
        kmin = ps & kmask
        nxt = jnp.concatenate(
            [node_s[:, 1:], jnp.full((B2, 1), -1, jnp.int32)], axis=1)
        is_end = (node_s != nxt) & (node_s != _INF)
        cnt = pos - startpos + 1
        rl = lens[:, None].astype(jnp.int32)
        ref = jnp.int32(200)
        sat_thresh = jnp.minimum(ref - 1, rl - 1 - kmin) - split_len + 2
        A = jnp.minimum(rl, ref) - split_len + 1
        exp_num = A * (rl - split_len)
        ok = is_end & ((cnt >= sat_thresh) | (cnt * rl >= exp_num))
        sidx = jnp.cumsum(ok.astype(jnp.int32), axis=1) - 1
        overflow = jnp.any(ok & (sidx >= cap))
        row = jax.lax.broadcasted_iota(jnp.int32, (B2, R), 0)
        tgt = jnp.where(ok & (sidx < cap), sidx, cap)
        out = jnp.full((B2, cap), -1, jnp.int32).at[row, tgt].set(
            node_s, mode="drop")
        return (out.astype(jnp.int64).sum()
                + overflow.astype(jnp.int32))

    def timed(f, *args):
        float(f(*args, jnp.int32(0)))
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            for r in range(reps):
                x = f(*args, jnp.int32(r))
            float(x)
            best = min(best, (time.time() - t0) / reps)
        return round(best * 1000, 1)

    res = {
        "sort_ms": timed(v_sort, nk, kv),
        "nogather_ms": timed(v_nogather, nk, kv, lens),
        "full_ms": timed(v_full, nk, kv, lens, seq_lens),
        "B2": B2, "R": R, "backend": jax.default_backend(),
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
