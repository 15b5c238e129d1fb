import json
from pathlib import Path

import pytest

from perfbench.lib import flops
from perfbench.lib.flops import Shape

CFG = Path(__file__).resolve().parents[1] / "configs"


def shape(name):
    return Shape.from_config(json.loads((CFG / f"{name}.json").read_text()))


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
