"""Continuous-batching serving demo: the PyTorch twin of
``examples/llm/serve.py``.

Drives :class:`~bitorch_engine_tpu_torch.models.generate.ContinuousBatcher`
with every serving feature on a self-contained random-weight model: 4-bit
projections, int8 KV, a paged KV pool, chunked multi-step decode, bucketed
attention windows, chunked prefill, and (optionally) a dp×tp mesh of
processes over ``torch.distributed``.  On the card the model takes the
serving form (bf16, fused q|k|v and gate|up, int8 embedding, w4 head, bf16
group metadata); on the CPU it is f32 and unfused.

    python examples_torch/llm/serve.py --demo                 # tiny model, CPU
    python examples_torch/llm/serve.py --demo --mesh 1,2      # 2 CPU processes, tp 2
    python examples_torch/llm/serve.py --model llama3_8b --page-size 64

With ``--mesh dp,tp`` every rank is a process of a gloo world
(``parallel.multiprocess.launch_world``; on the card the ranks share it);
rank 0's requests are printed.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np

MODELS = ("tiny_llama", "llama3_8b", "llama2_7b", "mistral_7b")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--demo", action="store_true", help="tiny model on the CPU")
    p.add_argument("--cpu", action="store_true", help="run the plain path on the CPU")
    p.add_argument("--model", default="tiny_llama", choices=MODELS)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=48)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--decode-chunk", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--page-size", type=int, default=None,
                   help="enable the paged KV pool with this page size")
    p.add_argument("--mesh", help="dp,tp: serve over a world of dp*tp processes")
    return p.parse_args(argv)


def serve(argv=None, mesh=None):
    """Build the model and the batcher, serve the seeded queue; returns
    ``(requests in submission order, seconds)``."""
    import torch

    from bitorch_engine_tpu_torch.device import resolve_device
    from bitorch_engine_tpu_torch.models import generate as gen
    from bitorch_engine_tpu_torch.models import llama as llama_mod
    from bitorch_engine_tpu_torch.utils.convert import prepare_params_for_cuda

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.demo or args.cpu else None)
    on_card = dev.type == "cuda"
    cfg = getattr(llama_mod, args.model)(
        dtype=torch.bfloat16 if on_card else torch.float32,
        max_seq_len=args.max_len,
        kv_cache_dtype="int8",
        quantize_embed=on_card,
        head_w_bit=4 if on_card else None,
        fuse_qkv=on_card,
        fuse_gate_up=on_card,
    )
    model = llama_mod.LlamaModel(cfg, device=dev, seed=0)
    if on_card:
        prepare_params_for_cuda(model, torch.bfloat16)

    kw = dict(
        num_slots=args.slots,
        max_len=args.max_len,
        eos_id=-1,
        decode_chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk,
    )
    if args.page_size:
        kw.update(
            kv_pages=1 + args.slots * (args.max_len // args.page_size),
            kv_page_size=args.page_size,
        )
    if mesh is not None:
        from bitorch_engine_tpu_torch.models.llama_sharding import shard_llama_params

        shard_llama_params(model, mesh)
        kw["mesh"] = mesh

    b = gen.ContinuousBatcher(model, **kw)
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        b.submit(rng.integers(1, cfg.vocab_size, plen).tolist(),
                 max_new_tokens=args.new_tokens)
        reqs.append(b.queue[-1])
    if on_card:
        torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        b.run()
    if on_card:
        torch.cuda.synchronize()
    return reqs, time.time() - t0


def serve_rank(argv):
    """One rank of a ``--mesh`` world: its requests' generated ids."""
    from bitorch_engine_tpu_torch.parallel import make_mesh

    dp, tp = (int(v) for v in parse_args(argv).mesh.split(","))
    reqs, dt = serve(argv, make_mesh(dp=dp, tp=tp))
    return {"generated": np.asarray([r.generated for r in reqs], np.int64), "seconds": dt}


def main(argv=None):
    """Serve and print; returns ``{"generated": (requests, new tokens) ids,
    "seconds", "tok_s"}`` (rank 0's under ``--mesh``)."""
    args = parse_args(argv)
    if args.mesh:
        from bitorch_engine_tpu_torch.parallel.multiprocess import launch_world

        dp, tp = (int(v) for v in args.mesh.split(","))
        argv = list(sys.argv[1:] if argv is None else argv)
        out = launch_world("examples_torch.llm.serve:serve_rank", dp * tp, {"argv": argv},
                           timeout=1800.0)[0]
        generated, dt = out["generated"], float(out["seconds"])
    else:
        reqs, dt = serve(argv)
        generated = np.asarray([r.generated for r in reqs], np.int64)
    gen_toks = generated.size
    print(f"served {len(generated)} requests in {dt:.2f}s "
          f"({gen_toks} generated tokens, {gen_toks/dt:.1f} tok/s incl. warm-up)")
    print("first request output ids:", generated[0][:16].tolist())
    return {"generated": generated, "seconds": dt, "tok_s": gen_toks / dt}


if __name__ == "__main__":
    main()
