"""The plain reference of a fine-tune step: the loss, its gradients and
DiodeMix's update, in float32 PyTorch (TF32 off).

The model is ``llama_ref``'s (GPTQ act-order projections ``w = s · (q −
z)`` put back by ``q_perm``, a symmetric w4 head, a bf16 embedding, f32
norms), trained on next-token cross entropy.  The forward keeps each
layer's input only; the backward runs layer by layer from the last,
recomputing the layer's forward with its weights as leaves, and each
layer's weights take their update as soon as their gradient is there, so
the reference holds one layer's activations and gradients at a time.

DiodeMix as the configuration states it (the JAX package's ``DiodeMix``):
AdamW moments ``m ← β1 m + (1 − β1) g``, ``v ← β2 v + (1 − β2) g²``, the
direction ``m / (√v + ε)``, the step ``lr · √(1 − β2^t) / (1 − β1^t)``;
a quantized weight's update is applied to its dequantized f32 weight and
requantized with its scales, after its zero points are refreshed (asym:
the rounded group means over logical rows ``r // group`` of the integer
zeros plus the update, clamped to ``[1, 16]``; sym: the zeros plus the
group means of the update); an act-order weight requantizes its stored
rows (stored row ``r`` is logical row ``q_perm[r]``, group ``r // group``);
an fp parameter is updated in f32 and cast back to its dtype.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ..lib import weights
from ..lib.flops import llama_shape
from .llama_ref import Ops, attention, no_tf32, rms_norm, rope, unpack_rows, unpack_zero_points

BETA1, BETA2, EPS = 0.99, 0.9999, 1e-6


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def step_size(lr: float, t: int) -> float:
    bc1 = 1.0 - _f32(BETA1) ** _f32(float(t))
    bc2 = 1.0 - _f32(BETA2) ** _f32(float(t))
    return float(_f32(lr) * torch.sqrt(bc2) / bc1)


class QLeaf:
    """A quantized weight as integer codes, scales and zeros; the logical
    f32 weight is made from them when it is used."""

    def __init__(self, rec: Dict[str, torch.Tensor]):
        self.codes = unpack_rows(rec["packed"]).to(torch.uint8)  # stored rows
        self.scales = rec["scales"].float()
        self.gptq = "q_perm" in rec
        self.perm = rec["q_perm"].long() if self.gptq else None
        self.zeros = (unpack_zero_points(rec["zeros"]).float() if self.gptq
                      else rec["zeros"].float())
        k = self.codes.shape[0]
        self.group = k // self.scales.shape[0]
        self.g = torch.arange(k, device=self.codes.device) // self.group

    def weight(self) -> torch.Tensor:
        q, s = self.codes.double(), self.scales.double()[self.g]
        if not self.gptq:
            return (q * s - self.zeros.double()[self.g]).float()
        w = (s * (q - self.zeros.double()[self.g])).float()
        out = torch.empty_like(w)
        out[self.perm] = w
        return out

    def update(self, update: torch.Tensor) -> None:
        """Requantize ``weight() − update`` after the zeros' refresh."""
        w = self.weight() - update
        k, n = w.shape
        gm = lambda x: x.reshape(k // self.group, self.group, n).mean(dim=1)  # noqa: E731
        if self.gptq:
            self.zeros = torch.clamp(torch.round(gm(self.zeros[self.g] + update)), 1, 16)
            ws = w[self.perm]
            q = torch.round(ws / self.scales[self.g] + self.zeros[self.g])
        else:
            self.zeros = self.zeros + gm(update)
            q = torch.round((w + self.zeros[self.g]) / self.scales[self.g])
        self.codes = torch.clamp(q, 0, 15).to(torch.uint8)


class Adam:
    def __init__(self, shape, device):
        self.m = torch.zeros(shape, device=device)
        self.v = torch.zeros(shape, device=device)

    def direction(self, g: torch.Tensor) -> torch.Tensor:
        self.m.mul_(BETA1).add_(g * (1.0 - BETA1))
        self.v.mul_(BETA2).add_(g * g * (1.0 - BETA2))
        return self.m / (torch.sqrt(self.v) + EPS)


def _layer(x, w, cfg, ops):
    """One block on ``x (b, L, h)`` with logical f32 weights ``w``."""
    s = llama_shape(cfg)
    b, L, _ = x.shape
    hd = s.head_dim
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, w["input_norm"], eps)
    q = ops.mm(h, w["q"]).reshape(b, L, s.heads, hd)
    k = ops.mm(h, w["k"]).reshape(b, L, s.kv_heads, hd)
    v = ops.mm(h, w["v"]).reshape(b, L, s.kv_heads, hd)
    pos = torch.arange(L, device=x.device).expand(b, L)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    x = x + ops.mm(attention(q, k, v, ops), w["o"])
    h = rms_norm(x, w["post_attn_norm"], eps)
    return x + ops.mm(F.silu(ops.mm(h, w["gate"])) * ops.mm(h, w["up"]), w["down"])


PROJS = ("q", "k", "v", "o", "gate", "up", "down")
NORMS = ("input_norm", "post_attn_norm")


class Model:
    """The reference's trainable state: quantized leaves, fp leaves, moments."""

    def __init__(self, cfg: Dict[str, Any], seed: int, device):
        self.cfg, self.device = cfg, device
        s = llama_shape(cfg)
        self.q: Dict[str, QLeaf] = {}
        self.fp: Dict[str, torch.Tensor] = {}
        for i in range(s.layers):
            w = weights.layer(cfg, seed, i, device)
            for n in ("q", "k", "v", "o"):
                self.q[f"layer_{i}.{n}"] = QLeaf(w["attn"][n])
            for n in ("gate", "up", "down"):
                self.q[f"layer_{i}.{n}"] = QLeaf(w["mlp"][n])
            for n in NORMS:
                self.fp[f"layer_{i}.{n}"] = w[n].float().clone()
            del w
        self.q["lm_head"] = QLeaf(weights.head(cfg, seed, device))
        self.fp["embed"] = weights.embedding(cfg, seed, device)["table"]  # bf16, as configured
        self.fp["final_norm"] = weights.final_norm(cfg, seed, device).float().clone()
        self.adam: Dict[str, Adam] = {}

    def layer_weights(self, i: int, grad: bool) -> Dict[str, torch.Tensor]:
        w = {n: self.q[f"layer_{i}.{n}"].weight().requires_grad_(grad) for n in PROJS}
        for n in NORMS:
            w[n] = self.fp[f"layer_{i}.{n}"].clone().requires_grad_(grad)
        return w

    def weight_of(self, name: str) -> torch.Tensor:
        """The leaf's current f32 value (a quantized one dequantized)."""
        return self.q[name].weight() if name in self.q else self.fp[name].float()

    def apply(self, name: str, g: torch.Tensor, size: float) -> torch.Tensor:
        """DiodeMix on one leaf; returns its gradient as the optimizer got it."""
        adam = self.adam.setdefault(name, Adam(g.shape, g.device))
        update = size * adam.direction(g)
        if name in self.q:
            self.q[name].update(update)
        else:
            p = self.fp[name]
            self.fp[name] = (p.float() - update).to(p.dtype)
        return g


def train_steps(cfg: Dict[str, Any], seed: int, batches: List[torch.Tensor], lr: float, device,
                precision: str = "f32") -> Dict[str, Any]:
    """Follow ``len(batches)`` steps from the seed's weights.  Returns each
    step's loss, each leaf's first gradient norm, and the model after the
    last step."""
    no_tf32()
    ops = Ops(precision)
    s = llama_shape(cfg)
    eps = cfg["rms_norm_eps"]
    m = Model(cfg, seed, device)
    losses: List[float] = []
    first: Dict[str, float] = {}
    for t, toks in enumerate(batches, start=1):
        size = step_size(lr, t)
        inp, labels = toks[:, :-1], toks[:, 1:]
        grads: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            xs = [m.fp["embed"][inp].float()]
            for i in range(s.layers):
                xs.append(_layer(xs[-1], m.layer_weights(i, False), cfg, ops))
        x = xs.pop().requires_grad_(True)
        head = m.q["lm_head"].weight().requires_grad_(True)
        fnorm = m.fp["final_norm"].clone().requires_grad_(True)
        logits = ops.mm(rms_norm(x, fnorm, eps), head)[..., : s.vocab]
        loss = F.cross_entropy(logits.reshape(-1, s.vocab), labels.reshape(-1))
        loss.backward()
        losses.append(float(loss.detach()))
        grads["lm_head"], grads["final_norm"] = head.grad, fnorm.grad
        dx = x.grad
        del logits, loss, head, fnorm, x
        for i in reversed(range(s.layers)):
            xi = xs.pop().requires_grad_(True)
            w = m.layer_weights(i, True)
            with torch.enable_grad():
                _layer(xi, w, cfg, ops).backward(dx)
            dx = xi.grad
            for n, leaf in w.items():
                grads[f"layer_{i}.{n}"] = leaf.grad
            del w, xi
            for n in PROJS + NORMS:  # this layer's update, now that its gradient is there
                name = f"layer_{i}.{n}"
                g = m.apply(name, grads.pop(name), size)
                if t == 1:
                    first[name] = float(g.norm())
        emb = torch.zeros(m.fp["embed"].shape, device=device)
        emb.index_add_(0, inp.reshape(-1), dx.reshape(-1, dx.shape[-1]))
        grads["embed"] = emb
        for name, g in grads.items():
            m.apply(name, g, size)
            if t == 1:
                first[name] = float(g.norm())
        del grads, dx, emb
    return {"losses": losses, "first_grad_norms": first, "model": m}
