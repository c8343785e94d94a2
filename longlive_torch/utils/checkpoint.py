"""Checkpoint conversion: the reference's PyTorch state dicts <-> the
port's parameters.

Covers the artifacts the reference loads:

- the Wan2.1-T2V DiT (``CausalWanModel`` / ``WanModel`` state dict; the
  t2v keys);
- ``Wan2.1_VAE.pth`` (``WanVAE_``: encoder, decoder and the two 1x1x1
  convs);
- LongLive generator checkpoints (``{"generator": sd}``, ``{"generator_ema":
  sd}``, ``{"model": sd}`` or a raw state dict, keys possibly carrying
  ``_fsdp_wrapped_module.`` / ``module.``) and PEFT LoRA adapters, folded
  into the base weights at load (W += alpha / rank * B @ A), so inference
  needs no adapter runtime.

The umT5 encoder's converter is ``models.t5.t5_params_from_torch``.  The
converters give the port's layout directly: DiT blocks as a list of
per-layer dicts, linears ``{"weight": [out, in], "bias"}``, the halfsplit
q/k permutation applied once at the end (``canonicalize_rope_layout``),
the VAE's fused convs packed (``vae.pack_fused_weights``).  The inverse
functions (``dit_state_dict``, ``vae_state_dict``, ``t5_state_dict``) give
the reference's key layout back, for checkpoints the reference can load.
"""

from __future__ import annotations

import re

import torch

from ..config import DiTConfig
from ..models import vae as V
from ..models.dit import canonicalize_rope_layout
from ..ops.rope import halfsplit_qk_perm


def clean_state_dict_keys(sd: dict) -> dict:
    """Strips the FSDP wrapper's ``_fsdp_wrapped_module.`` and a leading
    ``module.``."""
    out = {}
    for k, v in sd.items():
        k = k.replace("_fsdp_wrapped_module.", "")
        k = re.sub(r"^(module\.)", "", k)
        out[k] = v
    return out


def unwrap_generator_checkpoint(ckpt: dict, use_ema: bool = False) -> dict:
    """The generator's state dict from a ``{"generator" | "generator_ema" |
    "model": sd}`` checkpoint or a raw one, keys cleaned."""
    for key in (["generator_ema", "generator"] if use_ema else ["generator", "model"]):
        if key in ckpt and isinstance(ckpt[key], dict):
            return clean_state_dict_keys(ckpt[key])
    return clean_state_dict_keys(ckpt)


def fold_lora_into_dit_sd(sd: dict, lora_sd: dict, alpha_over_rank: float = 1.0) -> dict:
    """Folds PEFT LoRA weights into the base linears: W += (alpha / r) B @ A,
    on the CPU in float32 (each folded weight is float32; the converter
    casts it once).  Adapter keys ``[base_model.model.]<target>.lora_A
    [.default].weight``; a target missing from the base raises KeyError."""
    sd = dict(clean_state_dict_keys(sd))
    lora_sd = clean_state_dict_keys(lora_sd)
    pat = re.compile(r"(.+)\.lora_A(?:\.default)?\.weight$")
    for k, a in lora_sd.items():
        m = pat.match(k)
        if not m:
            continue
        base = re.sub(r"^base_model\.(model\.)*", "", m.group(1))
        b = lora_sd[k.replace("lora_A", "lora_B")]
        w_key = f"{base}.weight"
        if w_key not in sd:
            raise KeyError(f"LoRA target {w_key} not in base state_dict")
        delta = (torch.as_tensor(b).detach().cpu().float()
                 @ torch.as_tensor(a).detach().cpu().float()) * alpha_over_rank
        sd[w_key] = torch.as_tensor(sd[w_key]).detach().cpu().float() + delta
    return sd


# ---------------------------------------------------------------------------
# DiT


def dit_params_from_torch(sd: dict, cfg: DiTConfig = DiTConfig(), dtype=torch.bfloat16,
                          device="cpu") -> dict:
    """``CausalWanModel`` / ``WanModel`` state dict (t2v) -> the port's DiT
    parameters in ``dtype`` on ``device``."""
    if cfg.model_type != "t2v":
        raise NotImplementedError(f"model_type {cfg.model_type!r}: only the t2v keys are "
                                  "converted; the i2v keys wait for the I2V port")
    sd = clean_state_dict_keys(sd)

    def get(key):
        return torch.as_tensor(sd[key]).detach().to(device=device, dtype=dtype)

    def linear(prefix):
        p = {"weight": get(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["bias"] = get(f"{prefix}.bias")
        return p

    def attn(prefix):
        p = {n: linear(f"{prefix}.{n}") for n in ("q", "k", "v", "o")}
        if cfg.qk_norm:
            p["norm_q"] = {"scale": get(f"{prefix}.norm_q.weight")}
            p["norm_k"] = {"scale": get(f"{prefix}.norm_k.weight")}
        return p

    blocks = []
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        blk = {"self_attn": attn(f"{pre}.self_attn"), "cross_attn": attn(f"{pre}.cross_attn"),
               "ffn": {"fc1": linear(f"{pre}.ffn.0"), "fc2": linear(f"{pre}.ffn.2")},
               "modulation": get(f"{pre}.modulation")[0]}  # stored [1, 6, dim]
        if cfg.cross_attn_norm:
            blk["norm3"] = {"scale": get(f"{pre}.norm3.weight"), "bias": get(f"{pre}.norm3.bias")}
        blocks.append(blk)
    pe = get("patch_embedding.weight")  # [dim, in, pt, ph, pw]: patchify's channel-major order
    params = {
        "patch_embedding": {"weight": pe.reshape(pe.shape[0], -1),
                            "bias": get("patch_embedding.bias")},
        "text_embedding": {"fc1": linear("text_embedding.0"), "fc2": linear("text_embedding.2")},
        "time_embedding": {"fc1": linear("time_embedding.0"), "fc2": linear("time_embedding.2")},
        "time_projection": {"fc": linear("time_projection.1")},
        "blocks": blocks,
        "head": {"head": linear("head.head"), "modulation": get("head.modulation")[0]},
    }
    return canonicalize_rope_layout(params, cfg)


def dit_state_dict(params: dict, cfg: DiTConfig = DiTConfig()) -> dict:
    """The inverse of ``dit_params_from_torch``: the port's DiT parameters
    (bf16 or float32, not quantized) in the reference's key layout, the
    halfsplit permutation undone."""
    inv = None
    if cfg.rope_layout == "halfsplit":
        inv = torch.as_tensor(halfsplit_qk_perm(cfg.head_dim, cfg.num_heads)).argsort()
    sd = {}

    def linear(prefix, p, perm=None):
        for name in ("weight", "bias"):
            if p.get(name) is not None:
                t = p[name]
                sd[f"{prefix}.{name}"] = t if perm is None else t[perm.to(t.device)]

    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}"
        for group in ("self_attn", "cross_attn"):
            a = blk[group]
            perm = inv if group == "self_attn" else None
            for n in ("q", "k", "v", "o"):
                linear(f"{pre}.{group}.{n}", a[n], perm if n in ("q", "k") else None)
            for n in ("norm_q", "norm_k"):
                if n in a:
                    s = a[n]["scale"]
                    sd[f"{pre}.{group}.{n}.weight"] = s if perm is None else s[perm.to(s.device)]
        linear(f"{pre}.ffn.0", blk["ffn"]["fc1"])
        linear(f"{pre}.ffn.2", blk["ffn"]["fc2"])
        sd[f"{pre}.modulation"] = blk["modulation"][None]
        if "norm3" in blk:
            sd[f"{pre}.norm3.weight"] = blk["norm3"]["scale"]
            sd[f"{pre}.norm3.bias"] = blk["norm3"]["bias"]
    pe = params["patch_embedding"]["weight"]
    sd["patch_embedding.weight"] = pe.reshape(pe.shape[0], cfg.in_dim, *cfg.patch_size)
    sd["patch_embedding.bias"] = params["patch_embedding"]["bias"]
    for name in ("text_embedding", "time_embedding"):
        linear(f"{name}.0", params[name]["fc1"])
        linear(f"{name}.2", params[name]["fc2"])
    linear("time_projection.1", params["time_projection"]["fc"])
    linear("head.head", params["head"]["head"])
    sd["head.modulation"] = params["head"]["modulation"][None]
    return sd


# ---------------------------------------------------------------------------
# VAE

# the reference's Sequential indices inside a residual block
_RES_KEYS = (("norm1", "residual.0.gamma"), ("conv1", "residual.2"),
             ("norm2", "residual.3.gamma"), ("conv2", "residual.6"))


def _vae_layout(cfg: V.VAEConfig):
    """(reference prefix, port path, kind) of every module of ``WanVAE_``:
    kind "conv" (weight, bias), "gamma" ([C, 1, 1, 1] -> [C]), "res",
    "attn" or "resample" (its 2-D conv and an optional time conv)."""
    out = [("conv1", ("conv1",), "conv"), ("conv2", ("conv2",), "conv")]
    n = len(cfg.dim_mult)
    for side, blocks_key, per_stage in (("encoder", "downsamples", cfg.num_res_blocks),
                                        ("decoder", "upsamples", cfg.num_res_blocks + 1)):
        out.append((f"{side}.conv1", (side, "conv1"), "conv"))
        idx = 0
        for i in range(n):
            for _ in range(per_stage):
                out.append((f"{side}.{blocks_key}.{idx}", (side, blocks_key, idx), "res"))
                idx += 1
            if i != n - 1:
                out.append((f"{side}.{blocks_key}.{idx}", (side, blocks_key, idx), "resample"))
                idx += 1
        out += [(f"{side}.middle.0", (side, "middle", 0), "res"),
                (f"{side}.middle.1", (side, "middle", 1), "attn"),
                (f"{side}.middle.2", (side, "middle", 2), "res"),
                (f"{side}.head.0.gamma", (side, "head_norm"), "gamma"),
                (f"{side}.head.2", (side, "head_conv"), "conv")]
    return out


def vae_params_from_torch(sd: dict, cfg: V.VAEConfig = V.VAEConfig(), dtype=torch.float32,
                          device="cpu") -> dict:
    """``WanVAE_`` state dict -> the port's VAE parameters (encoder and
    decoder, their fused convs packed) in ``dtype`` on ``device``."""
    sd = clean_state_dict_keys(sd)

    def get(key):
        return torch.as_tensor(sd[key]).detach().to(device=device, dtype=dtype)

    def conv(prefix):
        p = {"w": get(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["b"] = get(f"{prefix}.bias")
        return p

    def module(prefix, kind):
        if kind == "conv":
            return conv(prefix)
        if kind == "gamma":
            return get(prefix).reshape(-1)
        if kind == "res":
            p = {k: (get(f"{prefix}.{r}").reshape(-1) if r.endswith("gamma")
                     else conv(f"{prefix}.{r}")) for k, r in _RES_KEYS}
            has_shortcut = f"{prefix}.shortcut.weight" in sd
            p["shortcut"] = conv(f"{prefix}.shortcut") if has_shortcut else None
            return p
        if kind == "attn":
            return {"norm": get(f"{prefix}.norm.gamma").reshape(-1),
                    "qkv": conv(f"{prefix}.to_qkv"), "proj": conv(f"{prefix}.proj")}
        p = {"conv": conv(f"{prefix}.resample.1")}
        if f"{prefix}.time_conv.weight" in sd:
            p["time_conv"] = conv(f"{prefix}.time_conv")
        return p

    out = {"encoder": {"downsamples": [], "middle": []},
           "decoder": {"upsamples": [], "middle": []}}
    for prefix, path, kind in _vae_layout(cfg):
        node = out
        for key in path[:-1]:
            node = node[key]
        m = module(prefix, kind)
        if isinstance(path[-1], int):
            node.append(m)
        else:
            node[path[-1]] = m
    V.pack_fused_weights(out["encoder"])
    V.pack_fused_weights(out["decoder"])
    out["mean"] = torch.tensor(V.WAN_LATENT_MEAN[: cfg.z_dim], dtype=torch.float32, device=device)
    out["std"] = torch.tensor(V.WAN_LATENT_STD[: cfg.z_dim], dtype=torch.float32, device=device)
    return out


def vae_state_dict(params: dict, cfg: V.VAEConfig = V.VAEConfig()) -> dict:
    """The inverse of ``vae_params_from_torch``: the port's VAE parameters
    in the reference's key layout (gammas [C, 1, 1, 1]; packed weights
    dropped)."""
    sd = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = p["w"]
        if p.get("b") is not None:
            sd[f"{prefix}.bias"] = p["b"]

    def gamma(key, g):
        sd[key] = g.reshape(-1, 1, 1, 1)

    for prefix, path, kind in _vae_layout(cfg):
        m = params
        for key in path:
            m = m[key]
        if kind == "conv":
            conv(prefix, m)
        elif kind == "gamma":
            gamma(prefix, m)
        elif kind == "res":
            for k, r in _RES_KEYS:
                if r.endswith("gamma"):
                    gamma(f"{prefix}.{r}", m[k])
                else:
                    conv(f"{prefix}.{r}", m[k])
            if m.get("shortcut") is not None:
                conv(f"{prefix}.shortcut", m["shortcut"])
        elif kind == "attn":
            gamma(f"{prefix}.norm.gamma", m["norm"])
            conv(f"{prefix}.to_qkv", m["qkv"])
            conv(f"{prefix}.proj", m["proj"])
        else:
            conv(f"{prefix}.resample.1", m["conv"])
            if "time_conv" in m:
                conv(f"{prefix}.time_conv", m["time_conv"])
    return sd


# ---------------------------------------------------------------------------
# umT5


def t5_state_dict(params: dict) -> dict:
    """The inverse of ``models.t5.t5_params_from_torch``: the port's umT5
    parameters in the reference ``T5Encoder``'s key layout."""
    sd = {"token_embedding.weight": params["token_embedding"], "norm.weight": params["norm"]}
    for i, p in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        sd[pre + "norm1.weight"] = p["norm1"]
        for n in ("q", "k", "v", "o"):
            sd[f"{pre}attn.{n}.weight"] = p["attn"][n]
        sd[pre + "pos_embedding.embedding.weight"] = p["pos_emb"]
        sd[pre + "norm2.weight"] = p["norm2"]
        sd[pre + "ffn.gate.0.weight"] = p["ffn"]["gate"]
        sd[pre + "ffn.fc1.weight"] = p["ffn"]["fc1"]
        sd[pre + "ffn.fc2.weight"] = p["ffn"]["fc2"]
    return sd
