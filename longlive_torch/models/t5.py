"""umT5 encoder (text conditioning).

The reference's ``umt5_xxl(encoder_only=True)``: 24 layers, dim 4096, FFN
10240, 64 heads, vocab 256384, per-layer bidirectional relative-position
embeddings, gated-GELU feed-forward and unscaled attention (no 1/sqrt(d)).
Plain PyTorch: the JAX package computes it with ``jnp.dot`` / ``einsum``
outside any Pallas kernel, so no kernel serves it.

Parameters: ``token_embedding`` [vocab, dim], ``norm`` [dim] and
``blocks``, a list of per-layer dicts (``norm1``, ``attn`` {q, k, v, o},
``pos_emb`` [buckets, heads], ``norm2``, ``ffn`` {gate, fc1, fc2}), each
linear a weight [out, in] without bias.

Numerics follow the JAX package: q, k and the logits in float32, the
key-mask bias -1e30, v and the probabilities in the activation dtype, every
other product accumulated in float32 and rounded once.

``encode_prompts`` is ``WanTextEncoder``'s semantics: encode the fixed
512-token window, then zero the features past each prompt's length.
``t5_encode_streamed`` keeps the weights in the host's memory and copies
one layer at a time to the device (the reference's low-memory mode).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import nn


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    eps: float = 1e-6
    text_len: int = 512

    @property
    def head_dim(self) -> int:
        return self.dim_attn // self.num_heads


def tiny_t5_config() -> T5Config:
    # max_dist stays 128: the reference hardcodes it
    return T5Config(vocab_size=128, dim=32, dim_attn=32, dim_ffn=48,
                    num_heads=4, num_layers=2, num_buckets=8, text_len=16)


def relative_position_buckets(lq: int, lk: int, num_buckets: int,
                              max_dist: int) -> torch.Tensor:
    """Bidirectional bucket ids [lq, lk] (int64, on the CPU).  The
    log-spaced buckets are computed in float64 and truncated, as the JAX
    package does: float32 would flip ids at the exact powers of two."""
    rel = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_dist / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(rel < max_exact, rel, large)
    return torch.from_numpy(buckets)


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS-only norm with float32 statistics; the weight multiplies in
    float32 before the cast back."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (weight.float() * y).to(x.dtype)


def init_t5_params(cfg: T5Config, dtype=torch.float32, device="cpu", seed: int = 0) -> dict:
    """Random init with the reference's scales (normal weights, ones for
    the norms), drawn in ``dtype`` on ``device`` from a generator seeded
    with ``seed``."""
    d, da, dff = cfg.dim, cfg.dim_attn, cfg.dim_ffn
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype) * std

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    blocks = [{
        "norm1": ones(d),
        "attn": {"q": normal((da, d), (d * cfg.head_dim) ** -0.5),
                 "k": normal((da, d), d ** -0.5),
                 "v": normal((da, d), d ** -0.5),
                 "o": normal((d, da), (cfg.num_heads * cfg.head_dim) ** -0.5)},
        "pos_emb": normal((cfg.num_buckets, cfg.num_heads),
                          (2 * cfg.num_buckets * cfg.num_heads) ** -0.5),
        "norm2": ones(d),
        "ffn": {"gate": normal((dff, d), d ** -0.5),
                "fc1": normal((dff, d), d ** -0.5),
                "fc2": normal((d, dff), dff ** -0.5)},
    } for _ in range(cfg.num_layers)]
    return {"token_embedding": normal((cfg.vocab_size, d), 1.0), "blocks": blocks,
            "norm": ones(d)}


def _key_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, 1, L] float32: 0 where the key is a token, -1e30 past it."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, torch.full_like(zero, -1e30))


def t5_block(cfg: T5Config, x: torch.Tensor, p: dict, buckets: torch.Tensor,
             key_bias: torch.Tensor) -> torch.Tensor:
    """One encoder layer: rel-pos bias, unscaled attention with a float32
    softmax, gated-GELU FFN.  x: [B, L, dim]."""
    b, l = x.shape[:2]
    n, hd = cfg.num_heads, cfg.head_dim
    pos_bias = p["pos_emb"][buckets].permute(2, 0, 1)[None].float()  # [1, n, L, L]
    h = t5_layer_norm(x, p["norm1"], cfg.eps)
    q = F.linear(h.float(), p["attn"]["q"].float()).reshape(b, l, n, hd).transpose(1, 2)
    k = F.linear(h.float(), p["attn"]["k"].float()).reshape(b, l, n, hd).transpose(1, 2)
    v = F.linear(h, p["attn"]["v"]).reshape(b, l, n, hd).transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) + pos_bias + key_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, n * hd)
    x = x + F.linear(o, p["attn"]["o"])

    h = t5_layer_norm(x, p["norm2"], cfg.eps)
    ff = F.linear(h, p["ffn"]["fc1"]) * nn.gelu_tanh(F.linear(h, p["ffn"]["gate"]))
    return x + F.linear(ff, p["ffn"]["fc2"])


@torch.no_grad()
def t5_encode(params: dict, cfg: T5Config, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """ids, mask: [B, L] integer -> features [B, L, dim] in the parameters'
    dtype, on their device."""
    l = ids.shape[1]
    x = params["token_embedding"][ids.long()]
    buckets = relative_position_buckets(l, l, cfg.num_buckets, cfg.max_dist).to(x.device)
    key_bias = _key_bias(mask.to(x.device))
    for p in params["blocks"]:
        x = t5_block(cfg, x, p, buckets, key_bias)
    return t5_layer_norm(x, params["norm"], cfg.eps)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, non_blocking=True)


@torch.no_grad()
def t5_encode_streamed(params: dict, cfg: T5Config, ids: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """``t5_encode`` with the weights in the host's memory (pinned, for a
    CUDA device: ``pin_t5_params``), computed on ``ids``' device: the
    embedding rows are gathered on the host, and each layer is copied to
    the device for its own forward and freed before the next.  The device
    holds one layer (~0.39 GB at full width) and the activations, never the
    11 GB encoder."""
    dev = ids.device
    l = ids.shape[1]
    x = params["token_embedding"][ids.long().cpu()].to(dev)
    buckets = relative_position_buckets(l, l, cfg.num_buckets, cfg.max_dist).to(dev)
    key_bias = _key_bias(mask.to(dev))
    for host in params["blocks"]:
        layer = _to(host, dev)
        x = t5_block(cfg, x, layer, buckets, key_bias)
        del layer
    return t5_layer_norm(x, params["norm"].to(dev), cfg.eps)


def encode_prompts(params: dict, cfg: T5Config, ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Encode the fixed-length window, then zero the features past each
    prompt's length."""
    feats = t5_encode(params, cfg, ids, mask)
    return feats * (mask.to(feats.device) > 0)[..., None].to(feats.dtype)


def pin_t5_params(params: dict) -> dict:
    """The parameters in the host's memory, pinned where CUDA is available
    (the streamed encode's copies then run at the link's full rate)."""
    def host(t):
        if not torch.cuda.is_available():
            return t.cpu()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    return {"token_embedding": host(params["token_embedding"]),
            "blocks": [{k: ({n: host(w) for n, w in v.items()} if isinstance(v, dict)
                            else host(v)) for k, v in p.items()} for p in params["blocks"]],
            "norm": host(params["norm"])}


# ---------------------------------------------------------------------------
# the reference's umT5 encoder state dict -> parameters


def t5_params_from_torch(sd: dict, cfg: T5Config, dtype=torch.bfloat16, device="cpu") -> dict:
    """The reference ``T5Encoder`` state dict -> the port's parameters, in
    ``dtype`` on ``device``."""
    from ..utils.checkpoint import clean_state_dict_keys

    sd = clean_state_dict_keys(sd)

    def get(key):
        return sd[key].detach().to(device=device, dtype=dtype)

    def layer(i):
        pre = f"blocks.{i}."
        return {"norm1": get(pre + "norm1.weight"),
                "attn": {n: get(f"{pre}attn.{n}.weight") for n in ("q", "k", "v", "o")},
                "pos_emb": get(pre + "pos_embedding.embedding.weight"),
                "norm2": get(pre + "norm2.weight"),
                "ffn": {"gate": get(pre + "ffn.gate.0.weight"),
                        "fc1": get(pre + "ffn.fc1.weight"),
                        "fc2": get(pre + "ffn.fc2.weight")}}

    return {"token_embedding": get("token_embedding.weight"),
            "blocks": [layer(i) for i in range(cfg.num_layers)],
            "norm": get("norm.weight")}


class T5TextEncoder:
    """Tokenizer + encoder, ``WanTextEncoder``'s facade.  ``tokenizer_path``
    names local HF assets (``google/umt5-xxl``, read with ``transformers``,
    imported here only); or pass a ``tokenizer`` callable with the HF
    interface.  ``low_memory=True`` keeps the weights in the host's memory
    and streams one layer at a time (``t5_encode_streamed``); otherwise
    they stay where they are given.  ``offload()`` moves resident weights
    to the host, after which encodes stream.  Encodes run on ``device``."""

    def __init__(self, params: dict, cfg: T5Config = T5Config(),
                 tokenizer_path: Optional[str] = None, low_memory: bool = False,
                 device="cuda", tokenizer=None):
        from ..utils.device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.low_memory = low_memory
        self.params = pin_t5_params(params) if low_memory else params
        self.tokenizer = tokenizer
        if tokenizer_path is not None:
            from transformers import AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)

    def offload(self) -> None:
        if not self.low_memory:
            self.params = pin_t5_params(self.params)
            self.low_memory = True

    def encode_ids(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        ids, mask = ids.to(self.device), mask.to(self.device)
        if self.low_memory:
            feats = t5_encode_streamed(self.params, self.cfg, ids, mask)
            return feats * (mask > 0)[..., None].to(feats.dtype)
        return encode_prompts(self.params, self.cfg, ids, mask)

    def __call__(self, text_prompts: List[str]) -> dict:
        assert self.tokenizer is not None, "tokenizer assets required"
        enc = self.tokenizer(text_prompts, padding="max_length", truncation=True,
                             max_length=self.cfg.text_len, return_tensors="np",
                             add_special_tokens=True)
        ids = torch.as_tensor(np.asarray(enc["input_ids"]), dtype=torch.int64)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"]), dtype=torch.int64)
        return {"prompt_embeds": self.encode_ids(ids, mask)}
