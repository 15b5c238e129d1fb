"""A configuration runs the architecture module its ``"arch"`` key names
(``archs/<arch>.py``, found by name): a new architecture is new files
alone, and the Llama family's module gives the weights it always gave."""

import dataclasses
import hashlib
import json

import pytest
import torch

from perfbench.lib import cells
from perfbench.lib.bench import load_arch, plan
from perfbench.lib.cells import run_cell

from .test_perfbench_extend import digests
from .tiny import tick, workspace

SEED = 2**33 + 5

# an architecture that is the Llama family's, and records which of its
# functions the harness called
TINY_ALT = '''
from perfbench.archs import llama

CALLED = []


def _recorded(name):
    inner = getattr(llama, name)

    def call(*args, **kwargs):
        CALLED.append(name)
        return inner(*args, **kwargs)

    return call


shape = _recorded("shape")
layer = _recorded("layer")
tree = _recorded("tree")
port_config = _recorded("port_config")
logits_at = _recorded("logits_at")
'''


def test_a_new_architecture_is_files_alone(tmp_path, monkeypatch):
    torch.set_num_threads(2)
    tick(monkeypatch)
    root = workspace(tmp_path)
    before = digests(root)
    pb = root / "perfbench"
    (pb / "archs/tiny_alt.py").write_text(TINY_ALT)
    cfg = json.loads((pb / "configs/tiny-moe.json").read_text())
    cfg["arch"] = "tiny_alt"
    (pb / "configs/tiny-alt.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "mixes/tiny-rag.json").read_text())
    (pb / "mixes/tiny-alt.json").write_text(json.dumps(mix))
    (pb / "limits/tiny-alt.json").write_text((pb / "limits/tiny-rag.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-alt", "source": "tiny",
                             "file": "perfbench/configs/tiny-alt.json", "reduced": [],
                             "why": "tiny"})
    bench["workloads"].append({"name": "tiny-alt", "config": "tiny-alt", "traffic": "tiny-alt",
                               "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-rag" in m.get("workloads", []):
            m["workloads"].append("tiny-alt")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    p = plan("tiny-alt", root)
    assert p.arch.__file__ == str(pb / "archs/tiny_alt.py")
    assert p.shape.routed_layers == 2
    out = run_cell(p, SEED, 1.0, False, "cpu", cells.clock())
    assert out["correct"], out["checks"]
    assert {"served_gap_mean", "served_far", "route_gap_mean"} <= set(out["checks"])
    assert {"shape", "tree", "port_config", "logits_at"} <= set(p.arch.CALLED)
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())
    # a configuration without the key is the Llama family's
    assert plan("tiny-rag", root).arch.__file__ == str(pb / "archs/llama.py")


def _tensors(obj, name=""):
    if isinstance(obj, torch.Tensor):
        yield name, obj
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _tensors(obj[k], f"{name}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _tensors(v, f"{name}[{i}]")
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), f"{name}.{f.name}")


def sha256(obj) -> str:
    """One digest of every tensor in ``obj``: its place, dtype, shape and bytes."""
    h = hashlib.sha256()
    for n, t in _tensors(obj):
        t = t.detach().contiguous()
        h.update(f"{n}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# ``weights.layer`` and ``model.tree`` of the commit before architectures
# were modules, on the tiny configurations
PINNED = {
    "tiny-moe": {
        "layer_0": "1c7ea586323eb4a3e7397f17fd966cb5864429bf2fce2ef9d14fb2999e482e2b",
        "layer_1": "de77ccff5243bf31550f2d3be83082ebd1824f6d99c3176023216be8f0157d71",
        "tree": "fd94fa52577d4693e84400ad77e9cfc9521ad7ca124c527893dc504507f27cf3",
    },
    "tiny-gptq": {
        "layer_0": "c1d5f6cbba29d0e948676962e127e33aa4864fae8c861e5aa05d15fdbe73785b",
        "layer_1": "1eec9374c35ceac75cf9f0fd64dbed6ebc3fe33409471c07bfddeb476cfeacb4",
        "tree": "649c1dfe748bef765464eed2aa903095811c1be452f89272e26cfc179b0ac61a",
    },
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_llama_weights_unchanged(tmp_path, name):
    root = workspace(tmp_path)
    cfg = json.loads((root / "perfbench/configs" / f"{name}.json").read_text())
    arch = load_arch(cfg, root)
    got = {f"layer_{i}": sha256(arch.layer(cfg, SEED, i, "cpu")) for i in range(2)}
    got["tree"] = sha256(arch.tree(cfg, SEED, "cpu"))
    assert got == PINNED[name]
