"""Bidirectional text-to-video sampler: the vanilla Wan2.1 T2V path.

A 50-step UniPC / DPM-Solver++ classifier-free-guidance sampler over the
full (non-causal) Wan model.  The cond and uncond (negative prompt)
forwards run as ONE batched forward per step; ``guide_scale`` combines
them.  Text encoding and VAE decoding live outside the class: prompt
embeddings in, latents out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DiTConfig
from ..models import nn
from ..models.dit import CrossKV, prepare_cross_kv
from ..models.dit_bidirectional import bidirectional_forward, bidirectional_forward_streamed
from ..ops import solvers as SV
from ..ops.rope import make_rope_tables
from ..parallel.sequence import sp_bidirectional_forward
from ..utils.device import resolve_device
from ..utils.memory import blocks_to_host, fetch_from_host

# The default negative prompt of the Wan configs (``sample_neg_prompt``).
DEFAULT_NEGATIVE_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)


def initial_noise(noise: Optional[torch.Tensor], generator: Optional[torch.Generator],
                  latent_shape: Optional[Tuple[int, ...]], device) -> torch.Tensor:
    """``noise`` as given, else a standard normal draw of ``latent_shape``
    from ``generator`` on ``device``."""
    if noise is not None:
        return noise.to(device)
    if generator is None or latent_shape is None:
        raise ValueError("pass either noise or (generator, latent_shape)")
    return torch.randn(latent_shape, generator=generator, device=device)


def prepare_condition(params: dict, cfg: DiTConfig, prompt_embeds: torch.Tensor,
                      dtype=torch.bfloat16) -> CrossKV:
    """A prompt's cross-attention K/V as the JAX pipelines condition: the
    text features in ``dtype`` (bf16) whatever the parameters' dtype.  With
    parameters in ``dtype`` (the card's) this is ``prepare_cross_kv``.  With
    float32 parameters it is the JAX package's mixed arithmetic: each linear
    in float32 rounded back to ``dtype``, and K's RMS norm as XLA computes
    it (x times its scale rounded to ``dtype``, the product and the weight
    in float32), so K comes out float32 and V in ``dtype``."""
    if params["text_embedding"]["fc1"]["weight"].dtype == dtype:
        return prepare_cross_kv(params, cfg, prompt_embeds, dtype)

    def linear(x, p):
        return nn.linear(x.to(p["weight"].dtype), p).to(x.dtype)

    te = params["text_embedding"]
    ctx = linear(nn.gelu_tanh(linear(prompt_embeds.to(dtype), te["fc1"])), te["fc2"])
    n, hd = cfg.num_heads, cfg.head_dim
    b, s, _ = ctx.shape
    ks, vs = [], []
    for blk in params["blocks"]:
        p = blk["cross_attn"]
        k = linear(ctx, p["k"])
        if cfg.qk_norm:
            scale = torch.rsqrt(k.float().square().mean(dim=-1, keepdim=True) + cfg.eps)
            k = k.float() * scale.to(dtype).float() * p["norm_k"]["scale"].float()
        ks.append(k.reshape(b, s, n, hd))
        vs.append(linear(ctx, p["v"]).reshape(b, s, n, hd))
    return CrossKV(k=torch.stack(ks), v=torch.stack(vs))


def guided_sampler(params: dict, cfg: DiTConfig, tables, guide_scale: float,
                   cross_both: CrossKV, cross_img: Optional[CrossKV] = None,
                   cond_latents: Optional[torch.Tensor] = None, streamed: bool = False,
                   sp_group=None):
    """``model_fn(x, t)`` for ``sample_flow``: x [B, ...] twice in one batch
    (cond then uncond, ``cross_both`` holding both prompts' K/V), with
    ``cond_latents`` [2B, F, C', H, W] appended on the channel axis (i2v),
    combined as uncond + guide_scale * (cond - uncond).  ``streamed``: the
    blocks live on the host (``bidirectional_forward_streamed``; t2v
    only).  ``sp_group``: the forward runs sequence-parallel over it
    (``parallel.sequence.sp_bidirectional_forward``; t2v only)."""

    def model_fn(x: torch.Tensor, t: float) -> torch.Tensor:
        b = x.shape[0]
        xx = torch.cat([x, x], dim=0)
        if cond_latents is not None:
            xx = torch.cat([xx, cond_latents.to(xx.dtype)], dim=2)
        tt = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
        if streamed:
            out = bidirectional_forward_streamed(params, cfg, tables, xx, tt, cross_both)
        elif sp_group is not None:
            out = sp_bidirectional_forward(params, cfg, tables, sp_group, xx, tt, cross_both)
        else:
            out = bidirectional_forward(params, cfg, tables, xx, tt, cross_both,
                                        cross_kv_img=cross_img)
        cond, uncond = out[:b], out[b:]
        return uncond + guide_scale * (cond - uncond)

    return model_fn


def concat_cross(a: CrossKV, b: CrossKV) -> CrossKV:
    """Two prompts' K/V [L, B, T, N, D] as one batch of 2B."""
    return CrossKV(k=torch.cat([a.k, b.k], dim=1), v=torch.cat([a.v, b.v], dim=1))


class Text2VideoPipeline:
    """Drives the bidirectional Wan model with a multistep flow solver.

    ``offload_blocks``: the DiT's blocks live in pinned host memory
    (``utils.memory.blocks_to_host``) and come to the card one layer ahead
    of their compute (``bidirectional_forward_streamed``); the prompts'
    cross-attention K/V are computed once by the same arithmetic as the
    resident sampler's, so the latents are the same bits.  ``mesh``: a
    ``parallel.mesh.make_mesh`` mesh whose ``sp`` group runs every forward
    sequence-parallel (Ulysses, ``parallel.sequence``); every rank of the
    group draws the same noise and holds the same latents.  It does not
    combine with ``offload_blocks``, which streams layers onto one card."""

    def __init__(self, params: dict, cfg: DiTConfig, mesh=None, offload_blocks: bool = False,
                 device="cuda"):
        if mesh is not None and offload_blocks:
            raise ValueError("offload_blocks streams layers on one device; it composes with "
                             "prompt rows sharded over ranks, not with sp")
        self.sp_group = None if mesh is None else mesh.get_group("sp")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.offload_blocks = offload_blocks
        self.params = blocks_to_host(params, self.device) if offload_blocks else params
        self.tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=self.device)

    def prepare_condition(self, prompt_embeds: torch.Tensor) -> CrossKV:
        """The prompt's cross-attention K/V (``prepare_condition``).  With
        ``offload_blocks`` the layers' k, v and norm_k come to the card
        once for it (0.28 GB in bf16 at the 1.3B widths)."""
        params = self.params
        if self.offload_blocks:
            cross = [{n: w for n, w in blk["cross_attn"].items() if n in ("k", "v", "norm_k")}
                     for blk in params["blocks"]]
            params = {**params, "blocks": [{"cross_attn": c}
                                           for c in fetch_from_host(cross, self.device)]}
        return prepare_condition(params, self.cfg, prompt_embeds.to(self.device))

    @torch.no_grad()
    def prepare_sampler(self, cond_embeds: torch.Tensor, null_embeds: torch.Tensor, *,
                        sampling_steps: int = 50, shift: float = 5.0, guide_scale: float = 5.0,
                        solver: str = "unipc"):
        """``(model_fn, coeffs)`` for ``solvers.sample_flow``: the guided
        model over both prompts' K/V and the solver's coefficients."""
        both = concat_cross(self.prepare_condition(cond_embeds),
                            self.prepare_condition(null_embeds))
        return (guided_sampler(self.params, self.cfg, self.tables, guide_scale, both,
                               streamed=self.offload_blocks, sp_group=self.sp_group),
                SV.make_coefficients(solver, sampling_steps, shift))

    @torch.no_grad()
    def generate_latents(
        self,
        cond_embeds: torch.Tensor,  # [B, text_len, text_dim]
        null_embeds: torch.Tensor,  # the negative prompt's embeddings, same shape
        noise: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        latent_shape: Optional[Tuple[int, ...]] = None,  # (B, F, C, H, W)
        sampling_steps: int = 50,
        shift: float = 5.0,
        guide_scale: float = 5.0,
        solver: str = "unipc",
        dtype=torch.bfloat16,
    ) -> torch.Tensor:
        """Clean latents [B, F, C, H, W] in ``dtype``.  The sampler starts
        from the noise rounded to ``dtype``."""
        noise = initial_noise(noise, generator, latent_shape, self.device)
        model_fn, coeffs = self.prepare_sampler(cond_embeds, null_embeds,
                                                sampling_steps=sampling_steps, shift=shift,
                                                guide_scale=guide_scale, solver=solver)
        return SV.sample_flow(model_fn, noise.to(dtype), coeffs)
