"""LongLive in PyTorch for one NVIDIA Hopper GPU.

Frame-level autoregressive long-video generation: a causal Wan2.1-1.3B DiT
denoises 3-frame latent blocks in 4 steps against a frame-sink + ring-window
KV cache, and a streaming causal 3D-conv VAE decodes the latents.

- ``longlive_torch.ops``      — scheduler, RoPE, KV ring cache, the attention
                                and fused causal-conv kernels (``csrc/``)
- ``longlive_torch.models``   — causal DiT (cached path) and the VAE decoder
- ``longlive_torch.pipeline`` — the block-by-block generation loop
- ``longlive_torch.utils``    — loading, parameter import, datasets, video IO

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
