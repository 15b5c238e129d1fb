"""The plain reference against the port's plain CPU path, on tiny seeded
models in the two forms the benchmark runs: the MoE serving form and the
GPTQ act-order fine-tune form.  (The test may import both; the reference
imports nothing of the program.)"""

import json

import pytest
import torch

from perfbench.lib import model as model_lib
from perfbench.lib.serve import RouteLog
from perfbench.reference import llama_ref
from perfbench.reference.train_ref import train_steps

from .tiny import workspace

SEED = 2**33 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return workspace(tmp_path_factory.mktemp("ref"))


def cfg_of(root, name):
    return json.loads((root / "perfbench/configs" / f"{name}.json").read_text())


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("name", ["tiny-moe", "tiny-gptq"])
def test_reference_logits_match_the_port(root, name):
    cfg = cfg_of(root, name)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg["vocab_size"], (2, 40), generator=g)
    model = model_lib.build(cfg, SEED, "cpu", 64)
    moe = "num_local_experts" in cfg
    log = RouteLog() if moe else None
    with torch.no_grad():
        got, _ = model(toks)
    routes = None
    if moe:
        fwd = log.take(cfg["num_hidden_layers"])[0]  # (layers, 2 · 40, k)
        log.close()
        routes = list(fwd.view(fwd.shape[0], 2, 40, -1).unbind(1))
    pos = torch.arange(40)
    st = {}
    ref = llama_ref.logits_at(cfg, SEED, list(toks), [pos, pos], "cpu", routes=routes, stats=st)
    ref = ref["f32"]
    # the port runs bf16 activations (the reference f32; a cache-less
    # forward reads no int8 cache): bf16's rounding through two layers
    for i in range(2):
        assert rel(got[i], ref[i]) < 3e-2
    if moe:  # the port's routes are the reference's but at near ties
        assert st["f32"]["route_gap"] < 1e-2
    # the fp8 control sits further off
    ctl = llama_ref.logits_at(cfg, SEED, list(toks), [pos, pos], "cpu", ("fp8",), routes)["fp8"]
    assert rel(ctl[0], ref[0]) > rel(got[0], ref[0])


def test_reference_train_step_matches_the_port(root):
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step

    from perfbench.lib import train_cell as tc

    cfg = cfg_of(root, "tiny-gptq")
    mix = {"batch": 2, "seq_len": 32}
    model = model_lib.build(cfg, SEED, "cpu", 32)
    step = make_train_step(model, tc.lm_loss, DiodeHyperParams(lr=1e-4, zeros_update_interval=1))
    batches = [tc.batch(mix, cfg["vocab_size"], SEED, i, "cpu") for i in range(2)]
    losses = [float(step(b)["loss"]) for b in batches]
    ref = train_steps(cfg, SEED, batches, 1e-4, "cpu")
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) / b < 1e-3
    # every gradient norm within bf16's rounding of the reference's
    ref_first = ref["first_grad_norms"]
    assert set(ref_first) == set(tc.leaves(step))


def test_one_wrong_token_is_counted():
    """``served_far`` counts a single wrong token among hundreds, which the
    mean gap lets through."""
    g = torch.Generator().manual_seed(3)
    ref = [torch.randn(40, 1000, generator=g) * 1.34 for _ in range(5)]
    best = [r.argmax(dim=-1).tolist() for r in ref]
    sound = llama_ref.served_gaps(ref, best, far=3.5)
    assert sound["served_far"] == 0 and sound["served_gap"] == 0
    wrong = [list(t) for t in best]
    wrong[2][17] = int(ref[2][17].argmin())
    got = llama_ref.served_gaps(ref, wrong, far=3.5)
    assert got["served_far"] == 1
    assert got["served_gap_mean"] < 0.6  # the mean's limit in the serving cell
