import json
from pathlib import Path

import pytest

from perfbench.lib import flops

CFG = Path(__file__).resolve().parents[1] / "configs"


def shape(name):
    return flops.llama_shape(json.loads((CFG / f"{name}.json").read_text()))


def test_mistral_layer_params():
    s = shape("mistral-7b-gptq-ft")
    # q 4096², k and v 4096 × 1024, o 4096², gate, up, down 4096 × 14336
    assert flops.layer_params(s) == 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    assert flops.layer_params(s) == pytest.approx(218.1e6, rel=1e-3)


def test_mistral_step_matmul_flops():
    s = shape("mistral-7b-gptq-ft")
    f = flops.train_step_flops(s, 4, 2048)
    # 6 × (16 layers × 218.1 M + the head's 4096 × 32000) × 8192 tokens
    assert f["matmul"] == pytest.approx(6 * (16 * 218.1e6 + 131.072e6) * 8192, rel=1e-3)
    assert f["matmul"] == pytest.approx(1.78e14, rel=5e-3)
    # causal attention: 2 products forward, 5 backward, over L(L+1)/2 pairs
    fwd = 16 * 4 * 4 * 32 * 128 * 2048 * 2049 / 2
    assert f["attention_forward"] == pytest.approx(fwd)
    assert f["attention_forward"] + f["attention_backward"] == pytest.approx(7.7e12, rel=1e-2)


def test_mixtral_top2_token_flops():
    s = shape("mixtral-8x7b-w4")
    attn = 4096 * 6144 + 4096 * 4096
    experts = 2 * 3 * 4096 * 14336
    router = 4096 * 8
    assert flops.token_matmul_flops(s) == 2 * 32 * (attn + experts + router)
    assert flops.token_matmul_flops(s) == pytest.approx(25.23e9, rel=1e-3)
    assert flops.head_flops(s) == 2 * 4096 * 32000
    # every expert runs under drop-free capacity: 4 × the top-2 experts' work
    assert flops.mlp_params(s, routed=False) - router == 4 * (flops.mlp_params(s) - router)


def test_attention_counts_the_keys_each_query_sees():
    s = shape("mixtral-8x7b-w4")
    per_key = 32 * 4 * 4096
    assert flops.attn_flops_prompt(s, 3) == per_key * (1 + 2 + 3)
    assert flops.attn_flops_token(s, 5) == per_key * 5


def test_weight_bytes_per_forward():
    s = shape("mixtral-8x7b-w4")
    params = 32 * (4096 * 6144 + 4096 * 4096 + 8 * 3 * 4096 * 14336)
    assert flops.weight_bytes_per_forward(s) == pytest.approx(params * (0.5 + 4 / 128))


# the counts of the commit before a shape's layers could differ
PARENT = {
    "mixtral-8x7b-w4": {
        "token_matmul_flops": 25235030016.0, "head_flops": 262144000.0,
        "attn_flops_prompt": 275146342400.0, "attn_flops_token": 536870912.0,
        "weight_bytes_per_forward": 24670896128.0,
        "train_step_flops": {"matmul": 626618548617216.0, "attention_forward": 4400193994752.0,
                             "attention_backward": 11000484986880.0,
                             "total": 642019227598848.0},
        "mlp_params": 352354304, "mlp_params_all": 1409318912, "attn_proj_params": 41943040,
    },
    "mistral-7b-gptq-ft": {
        "token_matmul_flops": 6979321856.0, "head_flops": 262144000.0,
        "attn_flops_prompt": 137573171200.0, "attn_flops_token": 268435456.0,
        "weight_bytes_per_forward": 1853882368.0,
        "train_step_flops": {"matmul": 177966264877056.0, "attention_forward": 2200096997376.0,
                             "attention_backward": 5500242493440.0,
                             "total": 185666604367872.0},
        "mlp_params": 176160768, "mlp_params_all": 176160768, "attn_proj_params": 41943040,
    },
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_counts_equal_the_parents(name):
    s = shape(name)
    got = {
        "token_matmul_flops": flops.token_matmul_flops(s), "head_flops": flops.head_flops(s),
        "attn_flops_prompt": flops.attn_flops_prompt(s, 1024),
        "attn_flops_token": flops.attn_flops_token(s, 1024),
        "weight_bytes_per_forward": flops.weight_bytes_per_forward(s),
        "train_step_flops": flops.train_step_flops(s, 4, 2048),
        "mlp_params": flops.mlp_params(s), "mlp_params_all": flops.mlp_params(s, routed=False),
        "attn_proj_params": flops.attn_proj_params(s),
    }
    assert got == PARENT[name]
    assert s.routed_layers == (s.layers if s.mlps[0].experts else 0)


def test_layers_that_differ():
    """hidden 64, 4 query heads and 2 KV heads of 32 (not 64 // 4), vocab
    100; layer 0 a dense MLP of 256, full attention; layers 1 and 2 route
    to 2 of 8 experts of 32 beside one shared expert of 64, layer 1 with a
    window of 8 keys.

    * q, k, v, o: 64 · (4 + 2 · 2) · 32 + 4 · 32 · 64 = 24,576 a layer.
    * MLPs a token: dense 3 · 64 · 256 = 49,152; routed 2 · 3 · 64 · 32 +
      3 · 64 · 64 + the router 64 · 8 = 25,088; every expert 8 · 6,144 +
      12,288 + 512 = 61,952.
    * a token's matmuls: 2 · (3 · 24,576 + 49,152 + 2 · 25,088) = 346,112.
    * weight bytes: (73,728 + 49,152 + 2 · 61,440) · (0.5 + 4 / 128) =
      245,760 · 0.53125 = 130,560 (the router not counted).
    * attention, 4 · 4 · 32 = 512 a key: a prompt of 5 (under the window)
      sees 15 keys in each layer, 45 · 512 = 23,040; a prompt of 12 sees
      78 in each full layer and 8 · 9 / 2 + 4 · 8 = 68 in the windowed
      one, 224 · 512 = 114,688; one token at context 5 sees 15 keys, at
      context 20, 20 + 8 + 20 = 48: 7,680 and 24,576.
    * a train step of 2 × 12: 6 · (173,056 + the head's 6,400) · 24 =
      25,841,664 matmul; attention 2 · 114,688 = 229,376 forward, 2.5 ×
      that backward; 26,644,480 in all.
    """
    s = flops.Shape(hidden=64, layers=3, heads=4, kv_heads=2, vocab=100, head_dim=32,
                    windows=(None, 8, None),
                    mlps=(flops.Mlp(256),) + (flops.Mlp(32, 8, 2, shared=1, shared_width=64),) * 2)
    assert s.routed_layers == 2
    assert flops.attn_proj_params(s) == 24_576
    assert [flops.mlp_params(s, layer=i) for i in range(3)] == [49_152, 25_088, 25_088]
    assert flops.mlp_params(s, routed=False, layer=2) == 61_952
    assert flops.token_matmul_flops(s) == 346_112
    assert flops.weight_bytes_per_forward(s) == 130_560
    assert flops.attn_flops_prompt(s, 5) == 23_040
    assert flops.attn_flops_prompt(s, 12) == 114_688
    assert flops.attn_flops_token(s, 5) == 7_680
    assert flops.attn_flops_token(s, 20) == 24_576
    assert flops.train_step_flops(s, 2, 12) == {
        "matmul": 25_841_664, "attention_forward": 229_376, "attention_backward": 573_440,
        "total": 26_644_480}
    with pytest.raises(ValueError):
        flops.Shape(hidden=64, layers=3, heads=4, kv_heads=2, vocab=100,
                    mlps=(flops.Mlp(256),) * 3, windows=(None, 8))
