"""Weights made from ``--seed`` on the device, in the dtype they are
served in, one draw per stacked tensor.

The tree has the port's parameter names and (in, out) layout, with every
layer's tensor stacked on axis 0. The same tensors go to the program and,
made again from the same seed, to the reference. Scales give each token a
peaked next-token distribution (logits of standard deviation about 3)
and biases and norm gains that are not trivial, so that every weight
shows in the comparison.
"""

from __future__ import annotations

from typing import Dict

import torch

LOGIT_STD = 3.0


def make_weights(cfg: dict, seed: int, device) -> Dict[str, object]:
    """The weight tree of configuration ``cfg`` in its ``torch_dtype``."""
    dtype = getattr(torch, cfg["torch_dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    L, D, F, V = (cfg["num_hidden_layers"], cfg["hidden_size"],
                  cfg["intermediate_size"], cfg["vocab_size"])
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]

    def normal(shape, std, mean=0.0):
        w = torch.randn(shape, generator=g, dtype=dtype, device=device)
        w.mul_(std)
        if mean:
            w.add_(mean)
        return w

    tied = cfg["tie_word_embeddings"]
    layers = {
        "attn_norm": normal((L, D), 0.1, 1.0),
        "wq": normal((L, D, q), D ** -0.5),
        "wk": normal((L, D, kv), D ** -0.5),
        "wv": normal((L, D, kv), D ** -0.5),
        "wo": normal((L, q, D), q ** -0.5),
        "mlp_norm": normal((L, D), 0.1, 1.0),
        "w_gate": normal((L, D, F), D ** -0.5),
        "w_up": normal((L, D, F), D ** -0.5),
        "w_down": normal((L, F, D), F ** -0.5),
    }
    if cfg["attention_bias"]:
        layers["bq"] = normal((L, q), 0.1)
        layers["bk"] = normal((L, kv), 0.1)
        layers["bv"] = normal((L, kv), 0.1)
    params = {"embed": normal((V, D), LOGIT_STD * D ** -0.5 if tied
                              else 0.02),
              "layers": layers,
              "final_norm": normal((D,), 0.1, 1.0)}
    if not tied:
        params["lm_head"] = normal((D, V), LOGIT_STD * D ** -0.5)
    return params


def leaves(params) -> Dict[str, torch.Tensor]:
    """Flat ``{"layers/wq": tensor, ...}`` view of the tree."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out
