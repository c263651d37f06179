#!/usr/bin/env python3
"""Where does the dense driver's E2E time go at realistic scale?

Times, on the same dataset the realistic bench builds:
  wire_pack   host wire packing only (no device work)
  dispatch    full driver loop (public infer_pe_links)
  device      probe-style composition on pre-staged batches
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

def main():
    pairs = int(os.environ.get("PROBE_PAIRS", 262144))
    batch_size = 16384
    print(f"# backend: {jax.default_backend()}", file=sys.stderr)

    from tools.realistic_bench import build_dataset
    from vstrains_tpu.core.fastq import load_read_pairs
    from vstrains_tpu.ops import pe_infer as P

    base = tempfile.mkdtemp(prefix="gapprobe_")
    gfa, fwd, rve, n_nodes = build_dataset(base, 32, pairs + 2048)
    index2seq = []
    with open(gfa) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if f and f[0] == "S":
                index2seq.append(f[2])
    k = 55
    reads = load_read_pairs(fwd, rve, k + 1, pad_to_multiple=32)
    ids = [str(i) for i in range(len(index2seq))]
    print(f"# nodes={n_nodes} pairs={reads.num_pairs}", file=sys.stderr)

    # 1. host wire packing alone
    t0 = time.time()
    nb = 0
    for kind, payload in P._wire_batches(reads, batch_size):
        nb += 1
    dt = time.time() - t0
    print(f"wire_pack  {dt:7.2f}s  ({nb} batches, "
          f"{reads.num_pairs / dt:.0f} pairs/s)")

    # 2. full driver, warm
    t0 = time.time()
    warm = P.infer_pe_links(ids, index2seq, _slice(reads, batch_size),
                            k, batch_size=batch_size)
    print(f"warmup     {time.time() - t0:7.2f}s")
    for i in range(2):
        t0 = time.time()
        res = P.infer_pe_links(ids, index2seq, reads, k,
                               batch_size=batch_size)
        dt = time.time() - t0
        print(f"driver[{i}]  {dt:7.2f}s  "
              f"({reads.num_pairs / dt:.0f} pairs/s)")


def _slice(reads, n):
    from vstrains_tpu.core.fastq import ReadPairBatch
    return ReadPairBatch(reads.fwd_codes[:n], reads.fwd_len[:n],
                         reads.rve_codes[:n], reads.rve_len[:n], 0, 0, n)


if __name__ == "__main__":
    main()
