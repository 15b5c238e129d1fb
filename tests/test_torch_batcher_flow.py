"""The port's ContinuousBatcher against the JAX package's: a tight page
pool reused, EOS, mixed-bucket admission, step-then-run, and the paged
kernel path (the JAX side's kernel in interpret mode)."""

import pytest

import _torch_threads  # noqa: F401  (one torch thread a test process)
from _torch_batcher_common import _both, _models, _prompts, _serve
from bitorch_engine_tpu.models import generate as jg
from bitorch_engine_tpu_torch.models import generate as tg
from bitorch_engine_tpu_torch.models import llama as tl


def test_tight_pool_reuses_pages_identical_to_jax():
    """3 usable pages (24 tokens) < num_slots × max_len: requests pass
    through the pool one after another."""
    got, want, tb = _both(_prompts(12, (5, 6, 4, 7)), 6, "int8", num_slots=2, max_len=32,
                          kv_pages=4, kv_page_size=8)
    assert got == want and len(tb.allocator.free) == 3


@pytest.mark.parametrize("chunk", [1, 4])
def test_eos_identical_to_jax(chunk):
    _, _, tmodel = _models("int8")
    prompts = _prompts(6, (4, 5, 3))
    eos = _serve(tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32), prompts, 6)[1][2]
    got, want, _ = _both(prompts, 6, "int8", num_slots=2, max_len=32, eos_id=eos,
                         decode_chunk=chunk)
    assert got == want and got[1][-1] == eos and len(got[1]) <= 3


def test_mixed_bucket_admission_identical_to_jax():
    """A 16-bucket head and three 8-bucket prompts behind it: two batched
    prefills, tokens equal to the JAX package's."""
    jmodel, params, tmodel = _models()
    prompts = _prompts(9, (12, 3, 4, 5))
    want = _serve(jg.ContinuousBatcher(jmodel, params, num_slots=4, max_len=32), prompts, 4)
    b = tg.ContinuousBatcher(tmodel, num_slots=4, max_len=32)
    calls = []
    inner = b._prefill_slots
    b._prefill_slots = lambda *a: calls.append(len(a[1])) or inner(*a)
    assert _serve(b, prompts, 4) == want
    assert calls == [1, 3]


def test_step_then_run_identical_to_jax():
    jmodel, params, tmodel = _models()
    p1, p2 = _prompts(8, (4, 5))

    def drive(b):
        b.submit(p1, max_new_tokens=3)
        b._admit()
        b.step()
        b.submit(p2, max_new_tokens=3)
        done = {r.uid: r.generated for r in b.run()}
        assert b.run() == []
        return done

    want = drive(jg.ContinuousBatcher(jmodel, params, num_slots=2, max_len=32))
    assert drive(tg.ContinuousBatcher(tmodel, num_slots=2, max_len=32)) == want


def test_paged_kernel_path_identical_to_jax(monkeypatch):
    """hd 128, max_len 512 (windows of 256 < the 512 view): the port's
    decode steps go through the write-back kernel's wrapper and its later
    prefill chunks through the read-only one (plain versions on the CPU);
    the JAX batcher runs its kernel in interpret mode.  Page reuse, inactive
    slots on the null page."""
    monkeypatch.setenv("BITORCH_PAGED_KERNEL", "interpret")
    calls = {"paged_prefix_attention": 0, "paged_prefix_attention_update": 0}
    for name in calls:
        def counting(*a, _inner=getattr(tl, name), _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        monkeypatch.setattr(tl, name, counting)
    kw = dict(num_slots=2, max_len=512, kv_pages=1 + 2 * 4, kv_page_size=8, prefill_chunk=8)
    got, want, tb = _both(_prompts(13, (12, 3, 9)), 5, "int8",
                          model_kw=(("hidden_size", 512), ("num_heads", 4)), **kw)
    assert got == want and (tb.allocator.table == 0).all()
    assert calls["paged_prefix_attention"] > 0 and calls["paged_prefix_attention_update"] > 0
