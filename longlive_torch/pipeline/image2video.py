"""Bidirectional image-to-video sampler: the vanilla Wan2.1 I2V path.

An i2v Wan model conditioned on (a) the first frame's VAE latents and a
first-frame mask, concatenated to the model's input channels, and (b) CLIP
image tokens attended by each block's image cross-attention; then the same
UniPC / DPM++ sampler with batched classifier-free guidance as
text-to-video.  The CLIP features and the conditioning latents ``y`` are
shared by the cond and uncond halves of the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import DiTConfig
from ..models import vae as V
from ..models.dit_bidirectional import prepare_img_cross_kv
from ..ops import solvers as SV
from ..ops.rope import make_rope_tables
from ..utils.device import resolve_device
from .text2video import concat_cross, guided_sampler, initial_noise, prepare_condition


def build_i2v_mask(num_pixel_frames: int, lat_h: int, lat_w: int, temporal_stride: int = 4,
                   device="cpu") -> torch.Tensor:
    """The first-frame mask in latent time, [stride, F_lat, lat_h, lat_w]
    float32: 1 for pixel frame 0 only; frame 0 is repeated ``stride``
    times (the VAE encodes it alone), then each group of ``stride`` pixel
    frames folds into the channel axis."""
    msk = torch.zeros((num_pixel_frames, lat_h, lat_w), dtype=torch.float32, device=device)
    msk[0] = 1.0
    msk = torch.cat([msk[:1].repeat(temporal_stride, 1, 1), msk[1:]], dim=0)
    f_lat = msk.shape[0] // temporal_stride
    return msk.reshape(f_lat, temporal_stride, lat_h, lat_w).permute(1, 0, 2, 3)


def encode_first_frame_condition(vae_params: dict, vae_cfg: V.VAEConfig, img: torch.Tensor,
                                 num_pixel_frames: int) -> torch.Tensor:
    """VAE-encodes [img, zeros x (F - 1)] (img [B, 3, H, W] in [-1, 1], in
    the VAE's dtype) and prepends the first-frame mask: y [B, stride + z,
    F_lat, lat_h, lat_w], [B, 20, ...] for the Wan VAE."""
    b, c, h, w = img.shape
    stride_t = 2 ** sum(vae_cfg.temperal_downsample)
    video = torch.cat([img[:, None],
                       torch.zeros((b, num_pixel_frames - 1, c, h, w), dtype=img.dtype,
                                   device=img.device)], dim=1)
    lat = V.vae_encode(vae_params, vae_cfg, video).permute(0, 2, 1, 3, 4)  # [B, z, F, h, w]
    _, _, _, lh, lw = lat.shape
    msk = build_i2v_mask(num_pixel_frames, lh, lw, stride_t, lat.device).to(lat.dtype)
    return torch.cat([msk[None].expand(b, *msk.shape), lat], dim=1)


class Image2VideoPipeline:
    """Drives the bidirectional i2v Wan model with a multistep flow solver.
    The encoders (T5, CLIP, VAE) run before it: it takes prompt
    embeddings, CLIP features and the conditioning tensor ``y``."""

    def __init__(self, params: dict, cfg: DiTConfig, device="cuda"):
        if cfg.model_type != "i2v":
            raise ValueError("Image2VideoPipeline needs an i2v DiT (model_type 'i2v')")
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tables = make_rope_tables(cfg.head_dim, cfg.rope_max_pos, device=self.device)

    @torch.no_grad()
    def prepare_sampler(self, cond_embeds: torch.Tensor, null_embeds: torch.Tensor,
                        clip_fea: torch.Tensor, y: torch.Tensor, *, sampling_steps: int = 40,
                        shift: float = 5.0, guide_scale: float = 5.0, solver: str = "unipc"):
        """``(model_fn, coeffs)`` for ``solvers.sample_flow``: the guided
        model over both prompts' K/V, the image tokens' K/V and ``y``, and
        the solver's coefficients."""
        dev = self.device
        both = concat_cross(*(prepare_condition(self.params, self.cfg, e.to(dev))
                              for e in (cond_embeds, null_embeds)))
        img = prepare_img_cross_kv(self.params, self.cfg, clip_fea.to(dev))
        y_f = y.to(dev).permute(0, 2, 1, 3, 4)  # channels behind time: [B, F, C', h, w]
        return (guided_sampler(self.params, self.cfg, self.tables, guide_scale, both,
                               concat_cross(img, img), torch.cat([y_f, y_f], dim=0)),
                SV.make_coefficients(solver, sampling_steps, shift))

    @torch.no_grad()
    def generate_latents(
        self,
        cond_embeds: torch.Tensor,  # [B, text_len, text_dim]
        null_embeds: torch.Tensor,
        clip_fea: torch.Tensor,  # [B, 257, clip_dim] (models.clip.encode_image)
        y: torch.Tensor,  # [B, stride + z, F, h, w] (encode_first_frame_condition)
        noise: Optional[torch.Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        latent_shape: Optional[Tuple[int, ...]] = None,  # (B, F, C, H, W)
        sampling_steps: int = 40,
        shift: float = 5.0,
        guide_scale: float = 5.0,
        solver: str = "unipc",
        dtype=torch.bfloat16,
    ) -> torch.Tensor:
        """Clean latents [B, F, C, H, W] in ``dtype``."""
        noise = initial_noise(noise, generator, latent_shape, self.device)
        model_fn, coeffs = self.prepare_sampler(cond_embeds, null_embeds, clip_fea, y,
                                                sampling_steps=sampling_steps, shift=shift,
                                                guide_scale=guide_scale, solver=solver)
        return SV.sample_flow(model_fn, noise.to(dtype), coeffs)
