"""The training loop: back-to-back fine-tune steps through ``make_train_step``.

Set-up builds one object, the train step with its model and DiodeMix
state (the weights and the reference are the configuration's
architecture's, ``archs/<arch>.py``: one without a train reference has
no training cell), and drives it through the first ``check_steps`` steps
with the window's own call and feed; those steps are the warm-up and the
ones the reference follows.  The window hands the same object on: step
after step, each on its own seeded batch, the host reading each step's
loss (the one host sync a step, as a training loop that logs its loss
has).

The numbers compared with the reference (each by the worst leaf where it
is a norm, as a share of the reference's norm of that leaf or of the
median leaf, whichever is larger):

* ``loss``: each of the first steps' loss against the reference's;
* ``grad``: the norm of the first gradient as the optimizer got it,
  worked out from its state after step 1 (``exp_avg_l / (1 − β1)``);
* ``moments``: the norms of DiodeMix's two AdamW moments after the first
  steps, ``exp_avg_l`` and the square root of ``exp_avg_s`` (as the
  update divides by it), the worse of the two: they hold every step's
  gradient, and they are what each quantized weight's update is made of
  even where the update stays under half a code step and moves no packed
  code.  (The norm of ``exp_avg_s`` itself, a fourth power of the
  gradient, is ruled by the head's few largest entries and swings from
  seed to seed: PERF.md §2);
* ``change``: the norm of each weight's change over the first steps (the
  packed codes and zeros dequantized; the fp parameters as they are), read
  before step ``check_steps + 1`` overwrites them.  Leaves whose reference
  gradient is under a thousandth of the median leaf's move by round-off
  alone and are left out.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Any, Dict, List

import torch

from . import model as model_lib
from . import weights

clock = time.perf_counter
_BATCH_SALT = 2_000_000


def batch(mix: Dict[str, Any], vocab: int, seed: int, i: int, device) -> torch.Tensor:
    """Step ``i``'s tokens ``(batch, seq_len + 1)``, drawn on the device."""
    g = weights.generator(seed, _BATCH_SALT + i, device)
    return torch.randint(0, vocab, (mix["batch"], mix["seq_len"] + 1), generator=g,
                         device=device)


def lm_loss(model, toks):
    from bitorch_engine_tpu_torch.training import cross_entropy_loss

    logits, _ = model(toks[:, :-1])
    return cross_entropy_loss(logits, toks[:, 1:])


def leaves(step) -> Dict[str, Any]:
    """The optimizer's leaves by a name the reference shares:
    ``layer_{i}.{q,k,v,o,gate,up,down,input_norm,post_attn_norm}``,
    ``lm_head``, ``embed``, ``final_norm``."""
    opt = step.optimizer
    out = {}
    for name, mod in opt.mpq:
        out[name.replace(".attn.", ".").replace(".mlp.", ".").replace("_proj", "")] = ("q", name, mod)
    for name, p in opt.fp:
        out[name.replace(".weight", "")] = ("fp", name, p)
    return out


def first_grad_norms(step, beta1: float) -> Dict[str, float]:
    opt = step.optimizer
    return {short: float(opt.state[name]["exp_avg_l"].norm()) / (1.0 - beta1)
            for short, (_, name, _) in leaves(step).items()}


def moment_norms(step) -> Dict[str, Dict[str, float]]:
    """Each leaf's moment norms: ``m`` of ``exp_avg_l``, ``v`` of ``√exp_avg_s``."""
    opt = step.optimizer
    out: Dict[str, Dict[str, float]] = {"m": {}, "v": {}}
    for short, (_, name, _) in leaves(step).items():
        out["m"][short] = float(opt.state[name]["exp_avg_l"].norm())
        out["v"][short] = float(opt.state[name]["exp_avg_s"].sqrt().norm())
    return out


def snapshot(step) -> Dict[str, Any]:
    """Every leaf's state on the host: packed codes and zeros of a
    quantized one, the value of an fp one."""
    out = {}
    for short, (kind, _, obj) in leaves(step).items():
        if kind == "q":
            qt = obj.qweight
            out[short] = {"packed": qt.packed.to("cpu", copy=True),
                          "zeros": qt.zeros.to("cpu", copy=True)}
        else:
            out[short] = obj.detach().to("cpu", copy=True)
    return out


def run_train(plan, seed: int, seconds: float, tracing: bool, device, t_start: float,
              check: bool = True) -> Dict[str, Any]:
    from bitorch_engine_tpu_torch.optim import DiodeHyperParams
    from bitorch_engine_tpu_torch.training import make_train_step

    from .cells import Profiled, span_fn, sync, trace_path, warm_profiler

    cfg, mix = plan.config, plan.mix
    if not hasattr(plan.arch, "train_steps"):
        raise ValueError(f"architecture {cfg.get('arch')!r} has no train reference: "
                         f"{plan.workload} cannot be checked")
    s = plan.shape
    cuda = torch.device(device).type == "cuda"
    model = model_lib.build(cfg, seed, device, mix["seq_len"], plan.arch)
    hp = DiodeHyperParams(lr=cfg["train"]["lr"],
                          zeros_update_interval=cfg["train"]["zeros_update_interval"])
    step = make_train_step(model, lm_loss, hp)
    span = span_fn(tracing)
    opt = step.optimizer
    inner = opt.step

    def opt_step():
        with span("optimizer"):
            inner()

    opt.step = opt_step
    if tracing and cuda:
        warm_profiler()
    n_check = mix["check_steps"]
    losses: List[float] = []
    first = None
    for i in range(n_check):
        losses.append(float(step(batch(mix, s.vocab, seed, i, device))["loss"]))
        if i == 0:
            first = first_grad_norms(step, hp.beta1)
    after, moments = snapshot(step), moment_norms(step)
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = clock() - t_start
    steps, failed, prof = [], 0, None
    t0 = clock()
    trace_at = t0 + mix["trace"]["start_share"] * seconds
    i = n_check
    while True:
        if tracing and prof is None and clock() >= trace_at:
            prof = Profiled(trace_path(plan), mix["trace"]["steps"], cuda)
        toks = batch(mix, s.vocab, seed, i, device)
        a = clock()
        with span("train_step"):
            loss = float(step(toks)["loss"])
        b = clock()
        profiled = prof is not None and not prof.done
        if profiled:
            prof.step()
        steps.append({"t0": a, "t1": b, "profiled": profiled})
        failed += not math.isfinite(loss)
        i += 1
        if clock() >= t0 + seconds and (not tracing or (prof is not None and prof.done)):
            break
    t1 = clock()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del opt.step
    del step, opt, inner, model
    sync(device)
    if cuda:
        torch.cuda.empty_cache()
    data = {"window_steps": steps, "failed": failed, "peak": peak,
            "tokens_per_step": mix["batch"] * mix["seq_len"], "losses": losses, "first": first,
            "moments": moments, "after": after}
    out = {"setup_s": setup_s, "window": (t0, t1), "data": data, "memory_peak_bytes": peak}
    if check:
        out["checks"] = check_train(plan, seed, losses, first, moments, after, device)
    return out


def train_e2e(run) -> Dict[str, float]:
    d = run.data
    return {"train_tok_s": len(d["window_steps"]) * d["tokens_per_step"] / run.window_s}


def worst_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The largest ``|prog − ref|`` over the leaves ``names``, each as a
    share of the larger of its reference norm and the median leaf's (a gap
    over a reference of nought is infinite)."""
    med = statistics.median(ref[n] for n in names)
    gaps = [0.0]
    for n in names:
        d, base = abs(prog[n] - ref[n]), max(ref[n], med)
        gaps.append(d / base if base > 0 else (math.inf if d > 0 else 0.0))
    return max(gaps)


def reference_readings(plan, seed, device, precision: str = "f32") -> Dict[str, Any]:
    """The reference's first steps from the seed (the architecture's
    ``train_steps``; ``reference/train_ref`` for the Llama family): its
    losses, first gradient norms, moment norms and each leaf's change
    norm; its state is freed before this returns."""
    cfg, mix, arch = plan.config, plan.mix, plan.arch
    batches = [batch(mix, plan.shape.vocab, seed, i, device) for i in range(mix["check_steps"])]
    ref = arch.train_steps(cfg, seed, batches, cfg["train"]["lr"], device, precision)
    m = ref.pop("model")
    ref["moments"] = {"m": {k: float(a.m.norm()) for k, a in m.adam.items()},
                      "v": {k: float(a.v.sqrt().norm()) for k, a in m.adam.items()}}
    ref["change"] = changes(arch, cfg, seed, list(ref["first_grad_norms"]), device,
                            lambda k, rec: m.weight_of(k))
    del m
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return ref


def changes(arch, cfg, seed, names, device, value_of) -> Dict[str, float]:
    """Each leaf's change norm over the first steps: ``value_of(name,
    record)`` is the side's f32 value after them (``record``: a quantized
    leaf's initial record, else ``None``)."""
    out = {}
    for k, w0 in initial_values(arch, cfg, seed, names, device):
        rec = w0 if isinstance(w0, dict) else None
        w0 = arch.dequant(rec) if rec is not None else w0
        out[k] = float((value_of(k, rec) - w0).norm())
        del w0
    return out


def program_value(after, device, dequant):
    """The program's leaf after the first steps, from its host snapshot:
    a quantized leaf's packed codes and zeros dequantized (``dequant``)
    with its record's scales and row map."""

    def value(k, rec):
        if isinstance(after[k], dict):
            return dequant(dict(rec, packed=after[k]["packed"].to(device),
                                zeros=after[k]["zeros"].to(device)))
        return after[k].to(device).float()

    return value


def compare(side: Dict[str, Any], ref: Dict[str, Any], limits) -> Dict[str, Dict[str, float]]:
    """The four numbers (see the module's notes) of a side's readings
    against the reference's."""
    rgrad = ref["first_grad_norms"]
    names = sorted(rgrad)
    med = statistics.median(rgrad[k] for k in names)
    moving = [k for k in names if rgrad[k] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["losses"], ref["losses"]))
    return {
        "loss": {"value": loss_gap, "limit": limits["loss"]},
        "grad": {"value": worst_gap(side["first_grad_norms"], rgrad, names),
                 "limit": limits["grad"]},
        "moments": {"value": max(worst_gap(side["moments"][k], ref["moments"][k], names)
                                 for k in ("m", "v")),
                    "limit": limits["moments"]},
        "change": {"value": worst_gap(side["change"], ref["change"], moving),
                   "limit": limits["change"]},
    }


def check_train(plan, seed, losses, first, moments, after, device, ref=None) -> Dict[str, Dict[str, float]]:
    """The program's first steps against the reference's.  ``ref``: the
    reference's readings, if already taken."""
    ref = ref or reference_readings(plan, seed, device)
    side = {"losses": losses, "first_grad_norms": first, "moments": moments,
            "change": changes(plan.arch, plan.config, seed, list(ref["first_grad_norms"]), device,
                              program_value(after, device, plan.arch.dequant))}
    return compare(side, ref, plan.limits)


def initial_values(arch, cfg, seed, names, device):
    """``(name, initial value)`` of each leaf in ``names``, made again from
    the seed one layer at a time (``arch.layer``; the head, the embedding
    and the final norm are ``weights.py``'s): a quantized leaf's record, an
    fp leaf's f32 value."""
    names = set(names)
    for i in range(arch.shape(cfg).layers):
        mine = [n for n in arch.PROJS + arch.NORMS if f"layer_{i}.{n}" in names]
        if not mine:
            continue
        w = arch.layer(cfg, seed, i, device)
        for n in mine:
            if n in arch.NORMS:
                yield f"layer_{i}.{n}", w[n].float()
            else:
                yield f"layer_{i}.{n}", (w["attn"] if n in ("q", "k", "v", "o") else w["mlp"])[n]
        del w
    if "lm_head" in names:
        yield "lm_head", weights.head(cfg, seed, device)
    if "embed" in names:
        yield "embed", weights.embedding(cfg, seed, device)["table"].float()
    if "final_norm" in names:
        yield "final_norm", weights.final_norm(cfg, seed, device).float()
