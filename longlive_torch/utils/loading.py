"""Model-artifact loading: the reference's checkpoint layout -> the port's
parameters.

Artifacts live where the JAX package looks for them: a
``wan_models/<model_name>/`` directory (VAE, umT5 weights and tokenizer,
base DiT weights), resolved against the working directory, and the
LongLive generator and LoRA checkpoints named by the config.  Missing
artifacts fall back to random initialisation with a loud warning, unless
``strict``.  The JAX package's ``ckpt_cache`` (an orbax cache of its torch
-> JAX conversion) has no counterpart: the port converts torch -> torch,
which such a cache would not shorten.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import torch

from ..config import DiTConfig, PipelineConfig
from ..models import clip as C
from ..models import dit as D
from ..models import t5 as T5
from ..models import vae as V
from . import checkpoint as ckpt


def _warn(msg: str):
    print(f"[longlive_torch] WARNING: {msg}", file=sys.stderr)


def _torch_load(path: str):
    # the reference's generator checkpoints may hold objects besides tensors
    return torch.load(path, map_location="cpu", weights_only=False)


def load_dit_params(config: PipelineConfig, cfg: DiTConfig, dtype=torch.bfloat16,
                    device="cuda", use_ema: bool = False, strict: bool = False) -> dict:
    """The LongLive generator: its checkpoint (``generator_ckpt``) with the
    LoRA adapter (``lora_ckpt``, a PEFT state dict or ``{"generator_lora":
    sd}``) folded in at ``adapter.alpha / adapter.rank`` from the config.
    Random init (seeded by ``config.seed``) when the checkpoint is absent,
    FileNotFoundError instead when ``strict``."""
    path = config.generator_ckpt
    if path and os.path.exists(path):
        sd = ckpt.unwrap_generator_checkpoint(_torch_load(path), use_ema=use_ema)
        if config.lora_ckpt and os.path.exists(config.lora_ckpt):
            lora = _torch_load(config.lora_ckpt)
            if isinstance(lora, dict) and "generator_lora" in lora:
                lora = lora["generator_lora"]
            adapter = (config.extras or {}).get("adapter") or {}
            alpha, rank = float(adapter.get("alpha", 256)), float(adapter.get("rank", 256))
            sd = ckpt.fold_lora_into_dit_sd(sd, lora, alpha_over_rank=alpha / rank)
        return ckpt.dit_params_from_torch(sd, cfg, dtype, device)
    if strict:
        raise FileNotFoundError(
            f"generator checkpoint {path!r} not found — a real run must not "
            "proceed on random weights")
    _warn(f"generator checkpoint {path!r} not found — using random init")
    return D.init_dit_params(cfg, dtype, device, seed=config.seed)


def _load_safetensors_dir(model_dir: str) -> Optional[dict]:
    """A (possibly sharded) safetensors checkpoint, the layout the released
    Wan2.1 base DiT ships in: the shards an index names, else every
    ``*.safetensors`` file of the directory; None when there is none."""
    import glob
    import json

    from safetensors.torch import load_file

    idx = os.path.join(model_dir, "diffusion_pytorch_model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            files = [os.path.join(model_dir, s)
                     for s in sorted(set(json.load(f)["weight_map"].values()))]
    else:
        files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        return None
    sd = {}
    for f in files:
        sd.update(load_file(f))
    return sd


def load_base_dit(model_dir: str, cfg: DiTConfig, dtype=torch.float32, device="cuda",
                  seed: int = 0, strict: bool = False) -> dict:
    """Base Wan DiT weights (teacher / critic) from ``wan_models/<name>/``:
    a safetensors directory, or a ``.pth`` state dict at ``model_dir``.
    Random init (seeded by ``seed``, zero head like the JAX package's
    default init) with a warning when absent, FileNotFoundError instead
    when ``strict``."""
    sd = _load_safetensors_dir(model_dir) if os.path.isdir(model_dir) else None
    if sd is None and os.path.isfile(model_dir):
        sd = _torch_load(model_dir)
    if sd is not None:
        return ckpt.dit_params_from_torch(sd, cfg, dtype, device)
    if strict:
        raise FileNotFoundError(
            f"base DiT weights not found under {model_dir!r}: distilling against a "
            "random teacher/critic silently ruins a run; pass --allow_random_weights "
            "to override")
    _warn(f"base DiT weights not found under {model_dir!r} — using random init")
    return D.init_dit_params(cfg, dtype, device, seed=seed)


def load_vae_params(config: PipelineConfig, dtype=torch.bfloat16, device="cuda",
                    vcfg: Optional[V.VAEConfig] = None,
                    strict: bool = False) -> Tuple[dict, V.VAEConfig]:
    """``wan_models/<model_name>/Wan2.1_VAE.pth`` (encoder and decoder);
    random init with a warning when absent, FileNotFoundError instead when
    ``strict``."""
    vcfg = vcfg or V.VAEConfig()
    path = os.path.join("wan_models", config.model_name, "Wan2.1_VAE.pth")
    if os.path.exists(path):
        return ckpt.vae_params_from_torch(_torch_load(path), vcfg, dtype, device), vcfg
    if strict:
        raise FileNotFoundError(f"VAE checkpoint {path!r} not found")
    _warn(f"VAE checkpoint {path!r} not found — using random init")
    return V.init_vae_params(vcfg, dtype, device, seed=0), vcfg


def load_clip_vision(config: PipelineConfig, dtype=torch.bfloat16, device="cuda"):
    """The CLIP vision tower of I2V, ``wan_models/<model_name>/
    models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth``: (params,
    config); random init (seed 0) with a warning when absent."""
    ccfg = C.CLIPVisionConfig()
    path = os.path.join("wan_models", config.model_name,
                        "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth")
    if os.path.exists(path):
        return C.clip_vision_params_from_torch(_torch_load(path), ccfg, dtype, device), ccfg
    _warn(f"CLIP checkpoint {path!r} not found — using random init")
    return C.init_clip_vision_params(ccfg, dtype, device, seed=0), ccfg


def load_text_encoder(config: PipelineConfig, dtype=torch.bfloat16, device="cuda",
                      strict: bool = False) -> Optional[T5.T5TextEncoder]:
    """The umT5 encoder from ``wan_models/<model_name>/``: its weights
    (``models_t5_umt5-xxl-enc-bf16.pth``) and tokenizer (``google/umt5-xxl``,
    read with ``transformers``).  ``low_memory: true`` in the config keeps
    the weights in the host's memory and streams one layer at a time to the
    device.  ``None`` when the assets are absent (callers then condition on
    random prompt embeddings), FileNotFoundError instead when ``strict``."""
    tcfg = T5.T5Config()
    base = os.path.join("wan_models", config.model_name)
    weights = os.path.join(base, "models_t5_umt5-xxl-enc-bf16.pth")
    tok = os.path.join(base, "google", "umt5-xxl")
    if os.path.exists(weights) and os.path.exists(tok):
        low_mem = bool((config.extras or {}).get("low_memory", False))
        params = T5.t5_params_from_torch(_torch_load(weights), tcfg, dtype,
                                         "cpu" if low_mem else device)
        return T5.T5TextEncoder(params, tcfg, tokenizer_path=tok, low_memory=low_mem,
                                device=device)
    if strict:
        raise FileNotFoundError(
            f"T5 assets not found under {base!r}: training would condition on random "
            "prompt embeddings; pass --allow_random_weights to override")
    _warn(f"T5 assets not found under {base!r} — text encoding unavailable; "
          "pipelines accept precomputed prompt embeddings instead")
    return None
