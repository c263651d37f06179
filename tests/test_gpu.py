"""Tests that need the card: the PE engine on the GPU against the
pure-Python oracle, and the exactness of its float32 pair matmuls there
(the card may run them in TF32). They skip on the CPU; chip_smoke.py
runs them on the GPU."""

import numpy as np
import pytest

from tests.oracle_pe import oracle_pe_matrices
from tests.test_pe_infer import (_coo_to_dense, _make_batch, _random_refs,
                                 _sample_reads)
from vstrains_tpu.ops.pe_infer import infer_pe_links

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("stats_mode", ["dense", "sparse"])
@pytest.mark.parametrize("stats_impl", ["scatter", "onehot"])
def test_engine_matches_oracle_on_gpu(gpu_device, monkeypatch, stats_mode,
                                      stats_impl):
    monkeypatch.setenv("VSTRAINS_STATS_IMPL", stats_impl)
    rng = np.random.RandomState(4)
    k = 21
    motif = _random_refs(rng, 1, [60])[0]
    refs = ([motif + s for s in _random_refs(rng, 6, [240] * 6)]
            + _random_refs(rng, 10, [300] * 10))
    fwd, rve = _sample_reads(rng, refs, 600, 100, k)
    batch = _make_batch(fwd, rve, k + 1)
    ids = [str(i) for i in range(len(refs))]
    res = infer_pe_links(ids, refs, batch, k, batch_size=256,
                         stats_mode=stats_mode)
    nm, sm, *_ = oracle_pe_matrices(refs, fwd, rve, k)
    n = len(refs)
    if stats_mode == "sparse":
        np.testing.assert_array_equal(
            _coo_to_dense(res.pair_keys, res.pair_counts, n), nm)
        np.testing.assert_array_equal(
            _coo_to_dense(res.short_keys, res.short_counts, n), sm)
    else:
        np.testing.assert_array_equal(res.node_mat, nm)
        np.testing.assert_array_equal(res.short_mat, sm)


def test_pair_matmuls_exact_on_gpu(gpu_device):
    from tests.test_pe_infer import check_pair_matmuls_exact
    check_pair_matmuls_exact(1 << 14, 64, all_ones=True)
    check_pair_matmuls_exact(1 << 14, 300, all_ones=False)
