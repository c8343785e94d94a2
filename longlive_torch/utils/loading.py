"""Model-artifact loading.

Artifacts live where the JAX package looks for them: a
``wan_models/<model_name>/`` directory (VAE, umT5 weights and tokenizer)
and the LongLive generator checkpoint named by the config.  Missing
artifacts fall back to random initialisation with a loud warning, unless
``strict``.  Reading checkpoints and the text encoder are not ported yet:
when the files exist, loading raises instead of silently using random
weights.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import torch

from ..config import DiTConfig, PipelineConfig
from ..models import dit as D
from ..models import vae as V


def _warn(msg: str):
    print(f"[longlive_torch] WARNING: {msg}", file=sys.stderr)


def load_dit_params(config: PipelineConfig, cfg: DiTConfig, dtype=torch.bfloat16,
                    device="cuda", use_ema: bool = False, strict: bool = False) -> dict:
    """The LongLive generator; random init (seeded by ``config.seed``) when
    the checkpoint is absent."""
    path = config.generator_ckpt
    if path and os.path.exists(path):
        raise NotImplementedError(
            f"generator checkpoint {path!r} exists, but checkpoint loading "
            "(utils/checkpoint.py) is not ported yet: ROADMAP queue 1, item 7")
    if strict:
        raise FileNotFoundError(
            f"generator checkpoint {path!r} not found — a real run must not "
            "proceed on random weights")
    _warn(f"generator checkpoint {path!r} not found — using random init")
    return D.init_dit_params(cfg, dtype, device, seed=config.seed)


def load_vae_params(config: PipelineConfig, dtype=torch.bfloat16, device="cuda",
                    vcfg: Optional[V.VAEConfig] = None,
                    strict: bool = False) -> Tuple[dict, V.VAEConfig]:
    vcfg = vcfg or V.VAEConfig()
    path = os.path.join("wan_models", config.model_name, "Wan2.1_VAE.pth")
    if os.path.exists(path):
        raise NotImplementedError(
            f"VAE checkpoint {path!r} exists, but checkpoint loading is not "
            "ported yet: ROADMAP queue 1, item 7")
    if strict:
        raise FileNotFoundError(f"VAE checkpoint {path!r} not found")
    _warn(f"VAE checkpoint {path!r} not found — using random init")
    return V.init_vae_params(vcfg, dtype, device, seed=0), vcfg


def load_text_encoder(config: PipelineConfig, strict: bool = False):
    """The umT5 encoder; ``None`` when its assets are absent (pipelines then
    take precomputed prompt embeddings)."""
    base = os.path.join("wan_models", config.model_name)
    weights = os.path.join(base, "models_t5_umt5-xxl-enc-bf16.pth")
    tok = os.path.join(base, "google", "umt5-xxl")
    if os.path.exists(weights) and os.path.exists(tok):
        raise NotImplementedError(
            f"T5 assets exist under {base!r}, but the umT5 encoder is not "
            "ported yet: ROADMAP queue 1, item 6")
    if strict:
        raise FileNotFoundError(f"T5 assets not found under {base!r}")
    _warn(f"T5 assets not found under {base!r} — text encoding unavailable; "
          "pipelines accept precomputed prompt embeddings instead")
    return None
