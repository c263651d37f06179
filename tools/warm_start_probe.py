#!/usr/bin/env python3
"""Fresh-process warm-start probe for the 50k-shape executables.

Measures the fresh-process PE warmup on the exact realistic_50k.py
workload shapes: the host k-mer table build (timed separately — it is
real fresh-process cost a user pays) plus the first batch dispatch
(kernel compile or persistent-cache load). Run it after
tools/realistic_50k.py (which populates the compile cache via the
package-import hook, utils/jaxcache.py) to measure what a user's
SECOND run pays.

Prints one JSON line: {"nodes": N, "warmup_seconds": W,
"table_build_seconds": T, "cache_files": C, "batch": B}.

Env: R50K_NODES / R50K_BS as in tools/realistic_50k.py (shapes must
match the populating run for the cache to serve them; compiled shapes
depend on read_len and bs, so only bs pairs are synthesized).
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    n_nodes = int(os.environ.get("R50K_NODES", 50_000))
    bs = int(os.environ.get("R50K_BS", 16384))

    import jax
    from bench import synth_workload
    from vstrains_tpu.core.fastq import ReadPairBatch, _pack
    from vstrains_tpu.ops.pe_infer import build_kmer_table, infer_pe_links

    from vstrains_tpu.utils.jaxcache import cache_dir as _cache_dir
    cache_dir = _cache_dir()
    # count only regular files — serialized executables — not
    # subdirectories or stray entries
    n_cache = (sum(1 for e in os.listdir(cache_dir)
                   if os.path.isfile(os.path.join(cache_dir, e)))
               if os.path.isdir(cache_dir) else 0)
    print(f"# backend={jax.default_backend()} cache_files={n_cache}",
          file=sys.stderr)

    # compiled shapes depend on (read_len, bs), not the full read count:
    # synthesize only bs pairs
    refs, fwd, rve, k = synth_workload(n_nodes=n_nodes, n_pairs=bs,
                                       node_len=200)
    ids = [str(i) for i in range(n_nodes)]
    fc, fl = _pack([s.encode() for s in fwd])
    rc, rl = _pack([s.encode() for s in rve])
    t0 = time.time()
    tbl = build_kmer_table(refs, k + 1)
    table_build = round(time.time() - t0, 2)

    warm = ReadPairBatch(fc, fl, rc, rl, 0, 0, bs)
    t0 = time.time()
    infer_pe_links(ids, refs, warm, k, batch_size=bs, table=tbl)
    warmup = round(time.time() - t0, 2)
    print(json.dumps({"nodes": n_nodes, "warmup_seconds": warmup,
                      "table_build_seconds": table_build,
                      "cache_files": n_cache, "batch": bs}))


if __name__ == "__main__":
    main()
