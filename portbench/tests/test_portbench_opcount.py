"""The roofline and FLOP functions against numbers worked by hand."""

import pytest

from portbench.harness import opcount


def test_k1_counts():
    # 8 users, 64 items, d 4, k 2
    assert opcount.k1_flops(8, 64, 4) == 2 * 8 * 64 * 4 == 4096
    # fp32: 4·4·(8 + 64) + 4·64 + 4·8·2 + 8·8·2 = 1152 + 256 + 64 + 128
    assert opcount.k1_bytes(8, 64, 4, 2, exact=True) == 1600
    # bf16 halves the table bytes only: 576 + 256 + 64 + 128
    assert opcount.k1_bytes(8, 64, 4, 2, exact=False) == 1024


def test_bound_picks_the_larger():
    # 67e9 FLOP at 67 TFLOP/s is 1 ms; 3.35e6 bytes is 1 µs
    assert opcount.bound_s(67e9, 3.35e6, exact=True) == pytest.approx(1e-3)
    # bf16: 989e6 FLOP is 1 µs, 3.35e9 bytes 1 ms
    assert opcount.bound_s(989e6, 3.35e9, exact=False) == pytest.approx(1e-3)


def test_served_batch_bound():
    # 256 x 10,380, d 50, k 30, bf16: 1,496,...-byte bound
    n_bytes = 2 * 50 * (256 + 10380) + 4 * 10380 + 4 * 256 * 325 + 8 * 256 * 30
    assert opcount.k1_bytes(256, 10380, 50, 30, exact=False) == n_bytes
    assert opcount.k1_bound_s(256, 10380, 50, 30, exact=False) == \
        pytest.approx(n_bytes / 3.35e12)


def test_model_flops():
    assert opcount.bpr_flops_per_sample(50) == 48 * 50 + 48 == 2448
    assert opcount.vbpr_flops_per_sample(50, 20000, 256) == pytest.approx(
        8 * 20000 * 25 + 5 * 20000 + 57 * 25 + 48 + 9 * 20000 * 26 / 256)
    assert opcount.train_flops_per_sample({"model": "bpr", "k": 50}, 256) \
        == 2448
    # a fold's scoring work, both scenarios: 72.5 GFLOP
    assert opcount.score_flops(69878, 8305 + 2075, 50) == 72_533_364_000


def test_eval_bound_counts_each_scenarios_candidates():
    import numpy as np

    from portbench.harness.drivers.evaluate import eval_k1_bound

    class Fold:
        n_users, n_items = 100, 64
        cands = {"im": 48, "om": 16}

        def scenario(self, name):
            return np.arange(self.cands[name]), None, None

    traffic = {"user_chunk": 64, "total": 2, "scenarios": ["im", "om"]}
    # chunks of 64 and 36 users against 48 and then 16 candidates, d 4
    want = sum(opcount.k1_bound_s(n_u, n_c, 4, 2, exact=True)
               for n_c in (48, 16) for n_u in (64, 36))
    assert eval_k1_bound({"k": 4}, Fold(), traffic) == pytest.approx(want)
    assert want < 2 * sum(opcount.k1_bound_s(n_u, 64, 4, 2, exact=True)
                          for n_u in (64, 36))
