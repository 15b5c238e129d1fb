"""The Llama family: Llama, Mistral, Qwen2 and Mixtral as the port's
``models.llama`` runs them.  Every layer full causal attention with default
RoPE, ``head_dim = hidden // heads``, and the same MLP (a dense SwiGLU, or
top-k routed SwiGLU experts with renormalized gates).  A configuration
without an ``"arch"`` key is this one.

Each name is the harness's own function for this family, unchanged:
the shape from the Hugging Face keys, the seeded weights of
``lib/weights.py`` and their flax-named tree of ``lib/model.py``, the port's
``LlamaConfig``, and the plain references of ``reference/``.
"""

from perfbench.lib import flops, model, weights
from perfbench.reference import llama_ref, train_ref

shape = flops.llama_shape
layer = weights.layer
tree = model.tree
port_config = model.port_config
logits_at = llama_ref.logits_at

# the train reference
train_steps = train_ref.train_steps
dequant = llama_ref.dequant
PROJS = train_ref.PROJS
NORMS = train_ref.NORMS
