"""The yardstick against hand counts at the cells' shapes: 8 prompts of
2048 tokens; granite: D 1024, 16 heads (8 K/V) of 64, 32 experts of 512,
top 8; mamba2: D 1536, 48 heads of 64, state 128, chunk 256."""
import json

import pytest

from portbench import roofline as y
from portbench.reference import mamba2, moe_transformer
from portbench.tests.helpers import ROOT

B, S = 8, 2048


def _model(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_peaks_are_the_data_sheets():
    assert y.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert y.HBM_BW == 3.35e12


def test_gmm_gate_launch_at_granites_prefill():
    rows = B * S * 8                      # every assignment kept
    nbytes, flops = y.gmm_cost(rows, 1024, 512, 32, rows, 32, 2)
    # x rows read, 32 experts' [1024, 512] read, the output rows written
    assert nbytes == (131072 * 1024 + 32 * 1024 * 512 + 131072 * 512) * 2 \
        + 4 * 33
    assert flops == 2 * 131072 * 1024 * 512
    # 0.1390 ms of bf16 work against 0.1302 ms of bytes: compute-bound
    assert y.bound_s(nbytes, flops, "bfloat16") == pytest.approx(
        137438953472 / 989e12)


def test_attention_launch_at_granites_prefill():
    nbytes, flops = y.attention_cost(B, S, S, 16, 8, 64, True, 0, 2)
    pairs = 2048 * 2049 // 2
    assert y.attention_pairs(S, S, True, 0) == pairs == 2098176
    assert flops == 4 * 8 * 16 * 64 * 2098176
    assert nbytes == (2 * 8 * 2048 * 16 * 64 + 2 * 8 * 2048 * 8 * 64) * 2
    assert y.attention_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2


def test_ssd_launch_at_mamba2s_prefill():
    assert y.ssd_chunk_len(2048, 256) == 256
    assert y.ssd_chunk_len(100, 256) == 100
    assert y.ssd_chunk_len(300, 256) == 150
    nbytes, flops = y.ssd_cost(64, 256, 48, 64, 128)
    pairs = 256 * 257 // 2
    assert flops == (2 * 64 * pairs * 128
                     + 2 * 64 * 48 * (pairs * 64 + 256 * 64 * 128))
    assert flops == 26359103488
    assert nbytes == 4 * (2 * 64 * 256 * 48 * 64 + 2 * 64 * 256 * 48
                          + 2 * 64 * 256 * 128 + 64 * 48 * 64 * 128)
    # 0.393 ms at the f32 peak against 0.157 ms of bytes
    assert y.bound_s(nbytes, flops, "float32") == pytest.approx(
        26359103488 / 67e12)


def test_granite_model_flops_a_call():
    per_token_layer = (2 * 1024 * (16 + 16) * 64 + 2 * 1024 * 1024
                       + 2 * 1024 * 32 + 8 * 3 * 2 * 1024 * 512)
    attn_layer = 4 * 8 * 16 * 64 * 2098176
    want = 24 * (16384 * per_token_layer + attn_layer) + 2 * 8 * 1024 * 49155
    got = moe_transformer.model_flops(_model("granite-moe-1b-a400m"), B, S)
    assert got == want
    assert 8.5e8 < got / 16384 < 8.6e8          # about 857 MFLOP a token


def test_mamba2_model_flops_a_call():
    inproj = 2 * 16384 * 1536 * (2 * 3072 + 2 * 128 + 48)
    conv = 2 * 16384 * 4 * (3072 + 256)
    intra = 26359103488
    across = 2 * 16384 * 128 * 48 * 64 + 2 * 8 * 8 * 48 * 64 * 128
    outproj = 2 * 16384 * 3072 * 1536
    want = 48 * (inproj + conv + intra + across + outproj) \
        + 2 * 8 * 1536 * 50280
    got = mamba2.model_flops(_model("mamba2-780m"), B, S)
    assert got == want
    assert 1.5e9 < got / 16384 < 1.6e9          # about 1.55 GFLOP a token
