"""The yardstick's frozen arithmetic against values worked out by hand."""
import pytest

from bench.cost import kernels, peaks, step


def test_peaks_are_the_data_sheet():
    assert (peaks.BF16_FLOPS, peaks.F32_FLOPS, peaks.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)


def test_causal_pairs():
    assert [kernels.causal_pairs(s) for s in (1, 2, 4)] == [1, 3, 10]


def test_flash_least_at_a_tiny_shape():
    # B 1, S 4, H 2, K 1, hd 2: 10 pairs a head, 20 in all; q 32 bytes, k 16,
    # the lse 32, o32 64
    least = kernels.flash_least_s(1, 4, 2, 1, 2)
    hand = {"flash_fwd": (4 * 20 * 2, 32 + 32 + 32 + 32 + 64),
            "flash_bwd_delta": (2 * 4 * 2 * 2, 32 + 64 + 32),
            "flash_bwd_dq": (6 * 20 * 2, 64 + 32 + 64 + 32),
            "flash_bwd_dkdv": (8 * 20 * 2, 64 + 32 + 64 + 32)}
    for name, (ops, nbytes) in hand.items():
        assert least[name] == (nbytes / 3.35e12, "bytes")
        assert ops / 989e12 < nbytes / 3.35e12


def test_flash_least_is_bound_by_operations_at_training_shapes():
    least = kernels.flash_least_s(3, 4096, 48, 8, 128)
    pairs = 4096 * 4097 // 2 * 3 * 48
    assert least["flash_fwd"] == pytest.approx((4 * pairs * 128 / 989e12, "operations"))
    assert least["flash_bwd_dkdv"][1] == "operations"
    assert least["flash_bwd_delta"][1] == "bytes"


def test_wkv6_least_at_a_tiny_shape():
    # B 1, S 2, H 1, hd 2: 4 elements, 8 state entries over the steps; a
    # state 16 bytes, u 8, one checkpoint 16
    least = kernels.wkv6_least_s(1, 2, 1, 2)
    assert least["wkv6_fwd"] == pytest.approx((max(60 / 67e12, 80 / 3.35e12), "bytes"))
    assert least["wkv6_bwd"] == pytest.approx((max(112 / 67e12, 136 / 3.35e12), "bytes"))


def test_train_step_flops_dense_by_hand():
    c = {"layer_pattern": "G", "d_model": 4, "num_heads": 2, "num_kv_heads": 1, "d_ff": 8,
         "vocab_size": 10, "num_layers": 1}
    # attention 16 + 16 + 16, gated MLP 96, embedding and head 80: 224
    assert step.n_params(c) == 224
    assert step.train_step_flops(c, 1, 3) == 6 * 224 * 3 + 3 * 2 * 3 * 3 * 2 * 2


def test_train_step_flops_rwkv_by_hand():
    c = {"layer_pattern": "W", "d_model": 64, "num_heads": 1, "d_ff": 8, "vocab_size": 10,
         "num_layers": 1}
    assert step.n_params(c) == 6 * 4096 + 2 * 64 * 8 + 4096 + 2 * 10 * 64
    assert step.train_step_flops(c, 1, 2) == 6 * 30976 * 2 + 3 * 4 * 2 * 64 * 64
