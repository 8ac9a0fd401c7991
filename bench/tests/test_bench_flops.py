"""``bench.flops`` against counts worked by hand."""
from __future__ import annotations

import pytest

from bench.flops import dense_forward_flops, gradstats_bytes, train_flops
from bench.weights import Dense, leaf_specs

# 1 layer, d 4, 2 query heads of hd 2 over 1 kv head, d_ff 8, vocab 10
SMALL = Dense(num_layers=1, d_model=4, num_heads=2, num_kv_heads=1, d_ff=8,
              vocab_size=10)


def test_small_forward_by_hand():
    # S = 3: q 2*3*4*4 = 96, k and v 2*3*4*2 = 48 each, o 96 -> 288;
    # MLP 3 products of 2*3*4*8 = 192 -> 576; causal attention q k^T and
    # P v at S^2/2 = 4.5 query-key pairs x hd 2 x 2 heads x 2 FLOPs each
    # -> 72; head 2*3*4*10 = 240
    assert dense_forward_flops(SMALL, 3) == 288 + 576 + 72 + 240
    assert train_flops(SMALL, 3, 5) == 3 * 1176 * 5


def test_stablelm_forward_by_hand():
    m = Dense(num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
              d_ff=5632, vocab_size=100352)
    S = 2048
    per_layer = (2 * S * 4 * 2048 * 2048 + 2 * S * 3 * 2048 * 5632
                 + 2 * S * S * 2048)
    assert dense_forward_flops(m, S) == 24 * per_layer + 2 * S * 2048 * 100352
    # the products' share is 2 S x (parameters less the embedding)
    n = sum(1 for _ in leaf_specs(m))
    assert n == 24 * 9 + 3


def test_gradstats_bytes_by_hand():
    # one pass, B 4, D 10: colsum reads 160 and writes 40; moments reads
    # 160 + 40, writes s and d (16 each) and n2 (4)
    assert gradstats_bytes([4, 4, 1], 10) == 200 + 236
    # two chunks of 2 rows: colsum 80 + 40 then 80 + 40 (accumulator)
    # + 40; moments 80 + 40 + 16 + 4 each
    assert gradstats_bytes([4, 2, 2], 10) == 120 + 140 + 160 + 140
    # a ragged last chunk of 1 row
    assert gradstats_bytes([3, 2, 2], 10) == (
        120 + 140 + (40 + 40 + 40) + (40 + 40 + 8 + 4))


def test_param_count_matches_the_port():
    from repro_torch.configs import get_config
    for arch in ("stablelm-1.6b", "phi3-medium-14b"):
        cfg = get_config(arch)
        m = Dense(num_layers=cfg.num_layers, d_model=cfg.d_model,
                  num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  d_ff=cfg.d_ff, vocab_size=cfg.vocab_size)
        assert m.param_count() == cfg.param_count()


@pytest.mark.parametrize("S", [1, 2, 64])
def test_attention_term_is_half_the_square(S):
    m = Dense(num_layers=1, d_model=4, num_heads=2, num_kv_heads=1, d_ff=8,
              vocab_size=10)
    zero_attn = dense_forward_flops(m, S) - 2 * S * S * 2 * 2
    assert zero_attn == S * (dense_forward_flops(m, 1) - 8)
