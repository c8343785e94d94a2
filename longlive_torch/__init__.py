"""LongLive in PyTorch for one NVIDIA Hopper GPU.

Frame-level autoregressive long-video generation: a causal Wan2.1-1.3B DiT
denoises 3-frame latent blocks in 4 steps against a frame-sink + ring-window
KV cache, and a streaming causal 3D-conv VAE decodes the latents.

- ``longlive_torch.ops``      — scheduler, flow solvers (UniPC, DPM++), RoPE,
                                KV ring cache, the attention (serving and
                                training) and fused causal-conv kernels
                                (``csrc/``)
- ``longlive_torch.models``   — causal DiT (cached path, serving and training
                                forms), the bidirectional DiT (DMD teacher and
                                critic, the vanilla samplers' t2v / i2v model),
                                the VAE, umT5 and CLIP
- ``longlive_torch.pipeline`` — the block-by-block generation loop and the
                                vanilla text- and image-to-video samplers
- ``longlive_torch.training`` — self-forcing rollouts, DMD losses, the trainer
- ``longlive_torch.utils``    — loading, parameter import, datasets, metrics,
                                training checkpoints, video IO

Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
