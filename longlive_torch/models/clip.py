"""CLIP (open-clip XLM-Roberta-CLIP ViT-H/14): the image conditioner of
image-to-video, and its XLM-Roberta text tower.

Only the vision tower runs on the I2V path: the ViT with ``use_31_block``
(the first 31 of 32 blocks, no post-norm) gives 257 tokens that feed the
DiT's ``img_emb``.  The text tower is kept for text-image similarity; no
Wan generation path runs it.

- The stride-14 patch conv is a patch extract and one matmul.
- LayerNorms compute in float32 and cast back.
- The attention (head dim 80 in the ViT, 64 in the text tower) is plain
  softmax attention with float32 logits, ``ops.attention.dense_attention``.
- Images are resized as the JAX package resizes them (``jax.image.resize``,
  ``method="bicubic"``): Keys' cubic kernel with a = -0.5 on half-pixel
  centres, widened by the scale when downscaling (antialiased), as
  separable weight matrices (``resize_bicubic``).  PyTorch's
  ``F.interpolate(mode="bicubic")`` takes a = -0.75 and no antialias.

Parameters: per-layer dicts in a list (``layers``), linears ``{"weight":
[out, in], "bias": [out]}``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.attention import dense_attention
from . import nn

# CLIP's normalisation constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """ViT geometry; the defaults are ViT-H/14 (clip_xlm_roberta_vit_h_14)."""

    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    out_dim: int = 1024
    activation: str = "gelu"  # 'gelu' | 'quick_gelu'
    eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def tiny_clip_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(image_size=28, patch_size=14, dim=32, mlp_ratio=2,
                            num_heads=4, num_layers=3, out_dim=16)


def _act(cfg: CLIPVisionConfig, x: torch.Tensor) -> torch.Tensor:
    return nn.quick_gelu(x) if cfg.activation == "quick_gelu" else nn.gelu_exact(x)


def _ln(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return nn.layer_norm(x, eps, p["scale"], p["bias"])


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] float32 weights of the antialiased Keys cubic resize
    (a = -0.5) along one axis, normalised per output sample, zero for a
    sample outside the input."""
    inv_scale = 1.0 / (n_out / n_in)  # as JAX forms it: the scale first
    kernel_scale = max(inv_scale, 1.0)  # widen the kernel when downscaling
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, height, width] in float32: the JAX package's
    ``jax.image.resize(..., method="bicubic")`` (antialiased when
    downscaling); an axis whose size does not change is left as it is."""
    x = img.float()
    h, w = x.shape[-2:]
    if h != height:
        x = torch.einsum("bchw,hH->bcHw", x, _cubic_weights(h, height, x.device))
    if w != width:
        x = torch.einsum("bchw,wW->bchW", x, _cubic_weights(w, width, x.device))
    return x


def preprocess_image(img: torch.Tensor, cfg: CLIPVisionConfig = CLIPVisionConfig()
                     ) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> the normalised [B, 3, S, S] CLIP input,
    float32."""
    s = cfg.image_size
    x = img.float()
    if tuple(x.shape[-2:]) != (s, s):
        x = resize_bicubic(x, s, s)
    x = x * 0.5 + 0.5
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)[None, :, None, None]
    return (x - mean) / std


def clip_vision_forward(params: dict, cfg: CLIPVisionConfig, x: torch.Tensor,
                        use_31_block: bool = True) -> torch.Tensor:
    """The ViT on preprocessed images x [B, 3, S, S]: the token sequence
    [B, 1 + P, dim] in the parameters' dtype.  ``use_31_block`` (the I2V
    path) runs all but the last block and no post-norm; otherwise every
    block (still returning tokens: no Wan path uses the pooled head)."""
    b = x.shape[0]
    p, d = cfg.patch_size, cfg.dim
    g = cfg.image_size // p
    dtype = params["patch_embedding"]["weight"].dtype
    xp = x.to(dtype).reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    tokens = nn.linear(xp.reshape(b, g * g, 3 * p * p), params["patch_embedding"])
    cls = params["cls_embedding"].to(dtype).expand(b, 1, d)
    tokens = torch.cat([cls, tokens], dim=1) + params["pos_embedding"].to(dtype)
    if "pre_norm" in params:
        tokens = _ln(tokens, params["pre_norm"], cfg.eps)
    n, hd = cfg.num_heads, cfg.head_dim
    s = tokens.shape[1]
    layers = params["layers"][: cfg.num_layers - 1] if use_31_block else params["layers"]
    for lp in layers:
        hh = _ln(tokens, lp["norm1"], cfg.eps)
        qkv = nn.linear(hh, lp["qkv"]).reshape(b, s, 3, n, hd)
        att = dense_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        tokens = tokens + nn.linear(att.reshape(b, s, n * hd), lp["proj"])
        hh = _ln(tokens, lp["norm2"], cfg.eps)
        tokens = tokens + nn.linear(_act(cfg, nn.linear(hh, lp["fc1"])), lp["fc2"])
    return tokens


def encode_image(params: dict, cfg: CLIPVisionConfig, img: torch.Tensor) -> torch.Tensor:
    """An image [B, 3, H, W] in [-1, 1] -> CLIP features [B, 257, dim] (at
    ViT-H/14's size): the I2V conditioning."""
    return clip_vision_forward(params, cfg, preprocess_image(img, cfg), use_31_block=True)


def _init(device, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)

    def xavier(d_in, d_out, dtype, bias=True):
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = (torch.rand((d_out, d_in), generator=gen, device=device) * 2 - 1) * lim
        p = {"weight": w.to(dtype)}
        if bias:
            p["bias"] = torch.zeros(d_out, dtype=dtype, device=device)
        return p

    def normal(shape, std, dtype):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    def ln(width, dtype):
        return {"scale": torch.ones(width, dtype=dtype, device=device),
                "bias": torch.zeros(width, dtype=dtype, device=device)}

    return xavier, normal, ln


def init_clip_vision_params(cfg: CLIPVisionConfig, dtype=torch.float32, device="cpu",
                            seed: int = 0) -> dict:
    """Random init: xavier-uniform linears with zero bias (the patch
    embedding without one), class and position embeddings N(0, 1/dim),
    unit LayerNorms.  Drawn on ``device`` from a generator seeded with
    ``seed``."""
    xavier, normal, ln = _init(device, seed)
    d, mid = cfg.dim, int(cfg.dim * cfg.mlp_ratio)
    gain = 1.0 / math.sqrt(d)
    return {
        "patch_embedding": xavier(3 * cfg.patch_size ** 2, d, dtype, bias=False),
        "cls_embedding": normal((1, 1, d), gain, dtype),
        "pos_embedding": normal((1, cfg.num_patches + 1, d), gain, dtype),
        "pre_norm": ln(d, dtype),
        "layers": [{"norm1": ln(d, dtype), "qkv": xavier(d, 3 * d, dtype),
                    "proj": xavier(d, d, dtype), "norm2": ln(d, dtype),
                    "fc1": xavier(d, mid, dtype), "fc2": xavier(mid, d, dtype)}
                   for _ in range(cfg.num_layers)],
        "post_norm": ln(d, dtype),
    }


def _sd_reader(sd: dict, dtype, device):
    def get(key):
        return torch.as_tensor(sd[key]).detach().to(device=device, dtype=dtype)

    def linear(prefix, bias=True):
        p = {"weight": get(f"{prefix}.weight")}
        if bias:
            p["bias"] = get(f"{prefix}.bias")
        return p

    def ln(prefix):
        return {"scale": get(f"{prefix}.weight"), "bias": get(f"{prefix}.bias")}

    return get, linear, ln


def clip_vision_params_from_torch(sd: dict, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                                  dtype=torch.bfloat16, device="cpu") -> dict:
    """The ``XLMRobertaCLIP`` state dict (``models_clip_*.pth``) -> the
    vision tower's parameters in ``dtype`` on ``device``; only the
    ``visual.*`` keys are read."""
    get, linear, ln = _sd_reader(sd, dtype, device)
    pe = get("visual.patch_embedding.weight")  # [dim, 3, p, p]

    def layer(i):
        pre = f"visual.transformer.{i}"
        return {"norm1": ln(f"{pre}.norm1"), "qkv": linear(f"{pre}.attn.to_qkv"),
                "proj": linear(f"{pre}.attn.proj"), "norm2": ln(f"{pre}.norm2"),
                "fc1": linear(f"{pre}.mlp.0"), "fc2": linear(f"{pre}.mlp.2")}

    return {
        "patch_embedding": {"weight": pe.reshape(cfg.dim, -1)},
        "cls_embedding": get("visual.cls_embedding"),
        "pos_embedding": get("visual.pos_embedding"),
        "pre_norm": ln("visual.pre_norm"),
        "layers": [layer(i) for i in range(cfg.num_layers)],
        "post_norm": ln("visual.post_norm"),
    }


# ---------------------------------------------------------------------------
# the XLM-Roberta text tower


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """xlm_roberta_large with CLIP's projection head."""

    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5
    out_dim: int = 1024

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def tiny_clip_text_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=64, max_seq_len=16, dim=32, num_heads=4,
                          num_layers=2, out_dim=16)


def xlm_roberta_forward(params: dict, cfg: CLIPTextConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids [B, L] -> features [B, L, dim].  Positions are pad_id +
    cumsum(non-pad) on the non-pad tokens; padding keys are masked with the
    float32 minimum."""
    b, s = ids.shape
    mask = (ids != cfg.pad_id).to(torch.int64)
    pos = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
    x = (params["token_embedding"][ids] + params["type_embedding"][torch.zeros_like(ids)]
         + params["pos_embedding"][pos])
    if cfg.post_norm:
        x = _ln(x, params["norm"], cfg.eps)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, torch.finfo(torch.float32).min)
    n, hd = cfg.num_heads, cfg.head_dim

    def attn(lp, h):
        q, k, v = (nn.linear(h, lp[name]).reshape(b, s, n, hd) for name in ("q", "k", "v"))
        return nn.linear(dense_attention(q, k, v, bias).reshape(b, s, n * hd), lp["o"])

    def ffn(lp, h):
        return nn.linear(nn.gelu_exact(nn.linear(h, lp["fc1"])), lp["fc2"])

    for lp in params["layers"]:
        if cfg.post_norm:
            x = _ln(x + attn(lp, x), lp["norm1"], cfg.eps)
            x = _ln(x + ffn(lp, x), lp["norm2"], cfg.eps)
        else:
            x = x + attn(lp, _ln(x, lp["norm1"], cfg.eps))
            x = x + ffn(lp, _ln(x, lp["norm2"], cfg.eps))
    if not cfg.post_norm:
        x = _ln(x, params["norm"], cfg.eps)
    return x


def clip_text_forward(params: dict, cfg: CLIPTextConfig, ids: torch.Tensor) -> torch.Tensor:
    """Mean of the non-pad tokens' features, then the two-layer GELU head:
    [B, out_dim]."""
    x = xlm_roberta_forward(params, cfg, ids)
    mask = (ids != cfg.pad_id).to(x.dtype)[..., None]
    pooled = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-9)
    h = params["head"]
    return nn.linear(nn.gelu_exact(nn.linear(pooled, h["fc1"])), h["fc2"])


def init_clip_text_params(cfg: CLIPTextConfig, dtype=torch.float32, device="cpu",
                          seed: int = 0) -> dict:
    """Random init: embeddings N(0, 0.02), xavier-uniform linears with zero
    bias (the head's without bias), unit LayerNorms."""
    xavier, normal, ln = _init(device, seed)
    d, mid = cfg.dim, (cfg.dim + cfg.out_dim) // 2
    return {
        "token_embedding": normal((cfg.vocab_size, d), 0.02, dtype),
        "type_embedding": normal((cfg.type_size, d), 0.02, dtype),
        "pos_embedding": normal((cfg.max_seq_len, d), 0.02, dtype),
        "norm": ln(d, dtype),
        "layers": [{"q": xavier(d, d, dtype), "k": xavier(d, d, dtype), "v": xavier(d, d, dtype),
                    "o": xavier(d, d, dtype), "norm1": ln(d, dtype),
                    "fc1": xavier(d, 4 * d, dtype), "fc2": xavier(4 * d, d, dtype),
                    "norm2": ln(d, dtype)}
                   for _ in range(cfg.num_layers)],
        "head": {"fc1": xavier(d, mid, dtype, bias=False),
                 "fc2": xavier(mid, cfg.out_dim, dtype, bias=False)},
    }


def clip_text_params_from_torch(sd: dict, cfg: CLIPTextConfig = CLIPTextConfig(),
                                dtype=torch.bfloat16, device="cpu") -> dict:
    """The ``XLMRobertaCLIP`` state dict's ``textual.*`` keys -> the text
    tower's parameters."""
    get, linear, ln = _sd_reader(sd, dtype, device)

    def layer(i):
        pre = f"textual.blocks.{i}"
        out = {n: linear(f"{pre}.attn.{n}") for n in ("q", "k", "v", "o")}
        out.update(norm1=ln(f"{pre}.norm1"), fc1=linear(f"{pre}.ffn.0"),
                   fc2=linear(f"{pre}.ffn.2"), norm2=ln(f"{pre}.norm2"))
        return out

    return {
        "token_embedding": get("textual.token_embedding.weight"),
        "type_embedding": get("textual.type_embedding.weight"),
        "pos_embedding": get("textual.pos_embedding.weight"),
        "norm": ln("textual.norm"),
        "layers": [layer(i) for i in range(cfg.num_layers)],
        "head": {"fc1": linear("textual.head.0", bias=False),
                 "fc2": linear("textual.head.2", bias=False)},
    }
