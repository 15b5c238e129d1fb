import collections
import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from perfbench.lib.serve import check_mix
from perfbench.lib.traffic import RequestStream, size_set

MIX = json.loads((Path(__file__).resolve().parents[1] / "mixes/rag-closed-32.json").read_text())


def draw(seed, n):
    s = RequestStream(MIX, 32000, seed)
    return [s.next() for _ in range(n)]


def test_same_seed_same_requests():
    a, b = draw(2**33 + 1, 150), draw(2**33 + 1, 150)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new_tokens == y.max_new_tokens
               for x, y in zip(a, b))


def test_other_seed_same_sizes_other_order():
    n = MIX["set_size"]
    a, b = draw(1, n), draw(2, n)
    sizes = lambda rs: sorted((len(r.prompt), r.max_new_tokens) for r in rs)  # noqa: E731
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new_tokens for r in a) == sorted(r.max_new_tokens for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert sizes(a) != sizes(b) or [r.prompt[0] for r in a] != [r.prompt[0] for r in b]


def test_prompt_lengths_follow_the_lognormal():
    p = size_set(MIX["prompt"], 1001)
    assert min(p) == 512 and max(p) == 2048
    assert abs(statistics.median(p) - 1024) <= 1
    # sigma 0.4: the quartiles at exp(±0.674 · 0.4) of the median
    q1, _, q3 = statistics.quantiles(p, n=4)
    assert abs(q1 - 1024 * np.exp(-0.6745 * 0.4)) < 8 and abs(q3 - 1024 * np.exp(0.6745 * 0.4)) < 8


def test_outputs_uniform_4_to_16():
    o = size_set(MIX["output"], MIX["set_size"])
    counts = collections.Counter(o)
    assert sorted(counts) == list(range(4, 17)) and set(counts.values()) == {MIX["set_size"] // 13}


def test_token_ids_in_vocab_and_cycles_repeat_the_set():
    rs = draw(7, 2 * MIX["set_size"])
    assert all(r.prompt.dtype == np.int32 and r.prompt.min() >= 0 and r.prompt.max() < 32000
               for r in rs)
    first, second = rs[: MIX["set_size"]], rs[MIX["set_size"]:]
    assert sorted(len(r.prompt) for r in first) == sorted(len(r.prompt) for r in second)


@pytest.mark.parametrize("extra", [{"think_time_s": 0.5}, {"sampling": "top_p"},
                                   {"batcher": dict(MIX["batcher"], temperature=0.7)}])
def test_loop_refuses_what_it_does_not_implement(extra):
    check_mix(MIX)
    with pytest.raises(ValueError, match="implements none of"):
        check_mix(dict(MIX, **extra))
