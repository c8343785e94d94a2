"""Model / pipeline configuration.

The same YAML keys as ``configs/*.yaml`` parse into typed frozen
dataclasses.  Field names, defaults and the key tables are those of the JAX
package's config module, so one config file drives either implementation.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Optional, Tuple

import yaml


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Geometry of the causal Wan DiT.

    Defaults = Wan2.1-T2V-1.3B at 480x832 with the LongLive attention window
    (12 frames, 3 of them a pinned sink, 3-frame blocks).
    """

    dim: int = 1536
    ffn_dim: int = 8960
    num_heads: int = 12
    num_layers: int = 30
    in_dim: int = 16
    out_dim: int = 16
    text_dim: int = 4096
    text_len: int = 512
    freq_dim: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    local_attn_size: int = 12  # frames in the attention window (-1 = global)
    sink_size: int = 3  # frames pinned at the start (frame sink)
    num_frame_per_block: int = 3
    rope_max_pos: int = 1024
    model_type: str = "t2v"
    clip_dim: int = 1280
    # "halfsplit": the q/k projection outputs are permuted at param-build
    # time so each head's complex pairs are stored (re half ++ im half);
    # attention is invariant to that permutation (ops.rope.halfsplit_qk_perm)
    rope_layout: str = "halfsplit"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class LatentGeometry:
    """480x832 pixels -> 60x104 latents -> 30x52 patches = 1560 tokens/frame."""

    channels: int = 16
    height: int = 60
    width: int = 104
    patch_size: Tuple[int, int, int] = (1, 2, 2)

    @property
    def tokens_h(self) -> int:
        return self.height // self.patch_size[1]

    @property
    def tokens_w(self) -> int:
        return self.width // self.patch_size[2]

    @property
    def frame_seq_length(self) -> int:
        return self.tokens_h * self.tokens_w


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Frame-sink + ring-window KV cache geometry: frame ``f`` lives at slot
    ``f`` if ``f < sink`` else ``sink + (f - ring_base) % ring_frames``."""

    sink_frames: int = 3
    ring_frames: int = 9  # local_attn_size - sink_size
    frame_seq: int = 1560

    @property
    def total_frames(self) -> int:
        return self.sink_frames + self.ring_frames

    @property
    def size_tokens(self) -> int:
        return self.total_frames * self.frame_seq

    @property
    def sink_tokens(self) -> int:
        return self.sink_frames * self.frame_seq

    @staticmethod
    def from_model(
        cfg: DiTConfig, geom: LatentGeometry, num_output_frames: int
    ) -> "CacheConfig":
        """Local window when ``local_attn_size != -1``, else the whole video."""
        sink = cfg.sink_size
        if cfg.local_attn_size != -1:
            ring = cfg.local_attn_size - cfg.sink_size
        else:
            ring = num_output_frames - cfg.sink_size
        return CacheConfig(
            sink_frames=sink, ring_frames=ring, frame_seq=geom.frame_seq_length
        )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Run configuration (the keys of configs/longlive_inference.yaml)."""

    denoising_step_list: Tuple[int, ...] = (1000, 750, 500, 250)
    warp_denoising_step: bool = True
    num_frame_per_block: int = 3
    timestep_shift: float = 5.0
    local_attn_size: int = 12
    sink_size: int = 3
    num_output_frames: int = 120
    context_noise: int = 0
    global_sink: bool = True
    seed: int = 0
    switch_frame_indices: Tuple[int, ...] = ()
    use_ema: bool = False
    num_samples: int = 1
    save_with_index: bool = False
    inference_iter: int = -1
    # int8 K cache with per-token scales (serving knob)
    kv_int8: bool = False
    # keep the last denoise pass's K/V instead of the clean-context commit
    reuse_last_denoise_kv: bool = False
    # kernel-operand cache layout; None = auto
    kernel_cache: Optional[bool] = None
    # rotate q inside the attention kernel's prologue
    fused_rope: bool = False
    eager_recache: bool = False
    reactive_recache_frames: Optional[int] = None
    recache_attn_impl: Optional[str] = None
    model_name: str = "Wan2.1-T2V-1.3B"
    data_path: Optional[str] = None
    output_folder: Optional[str] = None
    generator_ckpt: Optional[str] = None
    lora_ckpt: Optional[str] = None
    profile: bool = False
    extras: dict = dataclasses.field(default_factory=dict)

    def dit_config(self) -> DiTConfig:
        return DiTConfig(
            local_attn_size=self.local_attn_size,
            sink_size=self.sink_size,
            num_frame_per_block=self.num_frame_per_block,
        )


def _parse_switch_indices(v: Any) -> Tuple[int, ...]:
    # interactive configs store "40, 80, 120" as a string
    if v is None:
        return ()
    if isinstance(v, str):
        return tuple(int(s) for s in v.replace(",", " ").split())
    return tuple(int(s) for s in v)


# Every YAML key the framework consumes (inference and training CLIs and
# their extension keys).  Anything outside RECOGNIZED_KEYS draws a warning.
_CONSUMED_KEYS = frozenset({
    # shared model/schedule
    "denoising_step_list", "warp_denoising_step", "num_frame_per_block",
    "model_kwargs", "model_name", "seed", "context_noise", "global_sink",
    "num_train_timestep", "timestep_shift", "guidance_scale",
    # inference
    "num_output_frames", "switch_frame_indices", "data_path",
    "output_folder", "generator_ckpt", "lora_ckpt", "adapter", "profile",
    "use_ema", "num_samples", "save_with_index", "inference_iter",
    "negative_prompt",
    # training
    "distribution_loss", "lr", "lr_critic", "beta1", "beta2",
    "beta1_critic", "beta2_critic", "weight_decay",
    "dfake_gen_update_ratio", "gradient_accumulation_steps", "ema_weight",
    "ema_start_step", "num_training_frames", "min_num_training_frames",
    "slice_last_frames", "last_step_only", "ts_schedule", "ts_schedule_max",
    "real_name", "fake_name", "denoising_loss_type",
    "image_or_video_shape", "batch_size", "max_iters", "log_iters",
    "max_checkpoints", "vis_interval", "vis_video_lengths",
    "wandb_project", "wandb_entity", "wandb_key",
    "streaming_training", "streaming_chunk_size", "streaming_max_length",
    "streaming_min_new_frame", "switch_choices", "switch_mode",
    "switch_prompt_path", "train_first_chunk", "mixed_precision",
    # extension keys without a reference analogue
    "kv_int8", "reuse_last_denoise_kv", "kernel_cache", "fused_rope",
    "eager_recache", "recache_attn_impl", "reactive_recache_frames",
    "ckpt_cache", "low_memory",
    "parallel", "opt_on_host", "opt_async", "ema_on_host", "cache_int8",
    "staged_phases", "block_vjp", "page_generator", "teacher_stream",
    "tiny_debug", "allow_random_weights", "phase_ledger",
})

# Reference keys that configure its distributed runtime; accepted silently.
_REFERENCE_NOOP_KEYS = frozenset({
    "sharding_strategy", "generator_fsdp_wrap_strategy",
    "real_score_fsdp_wrap_strategy", "fake_score_fsdp_wrap_strategy",
    "text_encoder_fsdp_wrap_strategy", "gradient_checkpointing",
    "gc_interval", "trainer", "total_batch_size", "val_batch_size",
    "val_data_path", "val_switch_prompt_path", "vis_ema", "load_raw_video",
    "causal", "ckpt_step", "discriminator_lr_multiplier", "eval_first_n",
    "height", "width", "num_frames", "i2v", "independent_first_frame",
    "prompt_name", "prompt_path", "same_step_across_blocks",
})

RECOGNIZED_KEYS = _CONSUMED_KEYS | _REFERENCE_NOOP_KEYS


def warn_unknown_keys(raw: dict, source: str = "config") -> list:
    """A typo'd key must not silently do nothing."""
    unknown = sorted(k for k in (raw or {}) if k not in RECOGNIZED_KEYS)
    for k in unknown:
        print(f"[longlive_torch] WARNING: {source}: unknown config key "
              f"{k!r} is ignored", file=sys.stderr)
    return unknown


def load_pipeline_config(path: str) -> PipelineConfig:
    """Loads a reference-format YAML config (e.g. longlive_inference.yaml)."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    warn_unknown_keys(raw, source=path)
    return pipeline_config_from_dict(raw)


def pipeline_config_from_dict(raw: dict) -> PipelineConfig:
    mk = raw.get("model_kwargs", {}) or {}
    known = dict(
        denoising_step_list=tuple(raw.get("denoising_step_list", (1000, 750, 500, 250))),
        warp_denoising_step=bool(raw.get("warp_denoising_step", True)),
        num_frame_per_block=int(raw.get("num_frame_per_block", 3)),
        timestep_shift=float(mk.get("timestep_shift", 5.0)),
        local_attn_size=int(mk.get("local_attn_size", -1)),
        sink_size=int(mk.get("sink_size", 0)),
        num_output_frames=int(raw.get("num_output_frames", 120)),
        context_noise=int(raw.get("context_noise", 0)),
        global_sink=bool(raw.get("global_sink", False)),
        seed=int(raw.get("seed", 0)),
        switch_frame_indices=_parse_switch_indices(raw.get("switch_frame_indices")),
        use_ema=bool(raw.get("use_ema", False)),
        num_samples=int(raw.get("num_samples", 1)),
        save_with_index=bool(raw.get("save_with_index", False)),
        inference_iter=int(raw.get("inference_iter", -1)),
        model_name=raw.get("model_name", "Wan2.1-T2V-1.3B"),
        data_path=raw.get("data_path"),
        output_folder=raw.get("output_folder"),
        generator_ckpt=raw.get("generator_ckpt"),
        lora_ckpt=raw.get("lora_ckpt"),
        profile=bool(raw.get("profile", False)),
        kv_int8=bool(raw.get("kv_int8", False)),
        reuse_last_denoise_kv=bool(raw.get("reuse_last_denoise_kv", False)),
        kernel_cache=raw.get("kernel_cache"),  # None = auto
        fused_rope=bool(raw.get("fused_rope", False)),
        eager_recache=bool(raw.get("eager_recache", False)),
        recache_attn_impl=raw.get("recache_attn_impl"),
        reactive_recache_frames=(
            None if raw.get("reactive_recache_frames") is None
            else int(raw["reactive_recache_frames"])),
    )
    extras = {k: v for k, v in raw.items() if k not in known and k != "model_kwargs"}
    return PipelineConfig(extras=extras, **known)


# Model-family presets (Wan2.1 T2V 1.3B and 14B).
WAN_MODEL_CONFIGS = {
    "Wan2.1-T2V-1.3B": dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30),
    "Wan2.1-T2V-14B": dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40),
}


def dit_config_for(model_name: str, **overrides) -> DiTConfig:
    base = WAN_MODEL_CONFIGS.get(model_name)
    if base is None:
        raise KeyError(f"unknown model {model_name!r}; known: {list(WAN_MODEL_CONFIGS)}")
    return DiTConfig(**{**base, **overrides})


# Small geometry for unit tests: keeps every code path (sink, ring, blocks,
# RoPE splits) at a tiny fraction of the 1.3B cost.
def tiny_dit_config() -> DiTConfig:
    return DiTConfig(
        dim=96,
        ffn_dim=128,
        num_heads=4,
        num_layers=2,
        in_dim=4,
        out_dim=4,
        text_dim=32,
        text_len=16,
        freq_dim=32,
        local_attn_size=4,
        sink_size=1,
        num_frame_per_block=1,
        rope_max_pos=64,
    )


def tiny_geometry() -> LatentGeometry:
    return LatentGeometry(channels=4, height=8, width=8)
