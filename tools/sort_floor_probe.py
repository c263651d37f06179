#!/usr/bin/env python3
"""How much of the fused batch is the sort? Times, at the headline
shape (uniform random keys, sizes matching bench.py's batches):

  sort_pairs    lax.sort of (key, iota) at Q+M keys  [the sortfill core]
  sort_1op      lax.sort of key alone
  full_batch    the production fused kernel on a wire batch
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timed(f, *a, reps=10):
    # every variant reduces to one float, pulled per rep, so each
    # timed rep ends when the device has finished
    float(f(*a, jnp.int32(0)))
    t0 = time.time()
    for r in range(reps):
        float(f(*a, jnp.int32(r)))  # vary input; scalar sync
    return (time.time() - t0) / reps * 1000


def main():
    B = 16384
    K = 105            # 160-wide reads, L=56
    M = 262144         # bench table: 149k entries padded to 2^18
    Q = 2 * B * K
    print(f"# backend={jax.default_backend()} Q={Q} M={M} total={Q+M}",
          file=sys.stderr)
    rng = np.random.RandomState(0)
    key = jnp.asarray(rng.randint(-2**31, 2**31, Q + M, dtype=np.int64)
                      .astype(np.int32))
    iota = jnp.arange(Q + M, dtype=jnp.int32)

    f2 = jax.jit(lambda k, i, s: sum(
        jnp.sum(x.astype(jnp.float32))
        for x in jax.lax.sort((k + s, i), num_keys=1, is_stable=True)))
    print(f"sort_pairs   {timed(f2, key, iota):8.2f} ms")
    f1 = jax.jit(lambda k, s: jnp.sum(
        jax.lax.sort(k + s).astype(jnp.float32)))
    print(f"sort_1op     {timed(f1, key):8.2f} ms")
    f3 = jax.jit(lambda k, s: jnp.sum(
        jnp.argsort(k + s, stable=True).astype(jnp.float32)))
    print(f"argsort      {timed(f3, key):8.2f} ms")

    # production batch
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops import pe_infer as P
    refs, fwd, rve, k = synth_workload(n_pairs=B)
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    batch = ReadPairBatch(fc, fl, rc, rl, 0, 0, B)
    ids = [str(i) for i in range(len(refs))]
    t0 = time.time()
    P.infer_pe_links(ids, refs, batch, k, batch_size=B)
    print(f"# warm call (incl table build): {time.time() - t0:.2f}s",
          file=sys.stderr)
    t0 = time.time()
    P.infer_pe_links(ids, refs, batch, k, batch_size=B)
    print(f"full_batch   {(time.time() - t0) * 1000:8.2f} ms "
          f"(one 16384-pair batch through the public driver)")


if __name__ == "__main__":
    main()
