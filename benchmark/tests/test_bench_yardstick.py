"""The copied work arithmetic against counts by hand at small shapes."""

import pytest

from benchmark import yardstick as Y

CFG = {"hidden_dim": 4, "num_hidden_layers": 2, "n_heads": 2, "future_seq_length": 1,
       "window_size": 1, "obs_dim": 3, "action_dim": 2}


def test_layer_work_by_hand():
    # one row, one token, D=1, no prefix: 24 D^2 + 4 D (one pair)
    assert Y.layer_work(1, 1, 1, 0, elem=2) == (28, 2 * 1 * 1 * 2 + 12 * 2 + 13 * 4)
    # 2 rows x 2 tokens, D=2, P=1: pairs per row (1+1) + (1+2) = 5
    flops, nbytes = Y.layer_work(2, 2, 2, 1, n_layers=3, elem=4)
    assert flops == 3 * (4 * 24 * 4 + 2 * 5 * 4 * 2)
    assert nbytes == 2 * 4 * 2 * 4 + 3 * (12 * 4 * 4 + 13 * 2 * 4 + 2 * 2 * 1 * 2 * 4)


def test_bound_picks_the_larger_side():
    ms, by = Y.bound(989e12 / 1e3, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = Y.bound(1.0, 3.35e12 / 1e3)
    assert by == "bytes" and ms == pytest.approx(1.0)
    assert Y.peak_flops("float32") == pytest.approx(989e12 / 3)


def test_forward_flops_by_hand():
    # tokens: 1 + G + 2T = 4; embed 2 D (1 + G obs + T (obs + act)) = 2*4*(1+3+5)
    embed, body = Y.forward_flops(CFG, 1)
    assert embed == 72
    block = 24 * 4 * 16 + 4 * 16 * 4
    assert body == 2 * block + 2 * 1 * 4 * 2
    assert Y.denoiser_call_flops(CFG, 5) == 5 * (embed + body)


def test_busy_union_and_gaps():
    k = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0), ("d", 21.0, 22.0)]
    assert Y.busy_us(k) == 17.0
    assert Y.idle_gaps(k) == [(12.0, 20.0)]
    assert Y.busy_us([]) == 0.0
