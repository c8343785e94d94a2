"""Seeded inputs: the DiT's and the VAE decoder's weights, prompt
embeddings and noise, made on the device from ``--seed``.

Each tree's leaves are views into ONE flat buffer in the served dtype,
filled by one ``normal_`` call from a generator on the device, then scaled
leaf by leaf (an in-place multiply on the device).  The trees are in the
published layout (Wan2.1's interleaved q/k pairs), and the same tensors go
to the plain reference; ``program_dit`` / ``program_vae`` derive what the
program's set-up derives from them (its q/k channel order, its packed conv
weights) on a copy of the tree structure.

Scales (random weights, so that every part of the forward carries signal):
linears and convs N(0, fan-variance), biases N(0, 0.01^2), norm gains
1 + N(0, 0.05^2), the DiT's modulations N(0, 1/dim), its head non-zero.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

# Wan2.1 VAE's published latent statistics (``WanVAE`` mean / std)
WAN_LATENT_MEAN = [
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
]
WAN_LATENT_STD = [
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
]

Spec = Tuple[tuple, float, float]  # shape, std, mean


def _flat_tree(specs: Dict[str, Spec], dtype, device, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Leaves name -> tensor, all views of one buffer drawn in one call."""
    total = sum(math.prod(s) for s, _, _ in specs.values())
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    out, off = {}, 0
    for name, (shape, std, mean) in specs.items():
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[name] = t
        off += n
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    """'blocks.3.ffn.fc1.weight' -> nested dicts, integer keys -> lists."""
    root: dict = {}
    for name, t in flat.items():
        node = root
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(n):
        if isinstance(n, dict):
            if n and all(k.isdigit() for k in n):
                return [lists(n[str(i)]) for i in range(len(n))]
            return {k: lists(v) for k, v in n.items()}
        return n

    return lists(root)


def dit_specs(cfg: dict) -> Dict[str, Spec]:
    d, ffn = cfg["dim"], cfg["ffn_dim"]
    pt = math.prod(cfg["patch_size"])
    specs: Dict[str, Spec] = {}

    def lin(name, d_in, d_out):
        specs[name + ".weight"] = ((d_out, d_in), math.sqrt(2.0 / (d_in + d_out)), 0.0)
        specs[name + ".bias"] = ((d_out,), 0.01, 0.0)

    def gain(name, n):
        specs[name] = ((n,), 0.05, 1.0)

    lin("patch_embedding", cfg["in_dim"] * pt, d)
    lin("text_embedding.fc1", cfg["text_dim"], d)
    lin("text_embedding.fc2", d, d)
    lin("time_embedding.fc1", cfg["freq_dim"], d)
    lin("time_embedding.fc2", d, d)
    lin("time_projection.fc", d, 6 * d)
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}."
        for a in ("self_attn", "cross_attn"):
            for n in ("q", "k", "v", "o"):
                lin(b + f"{a}.{n}", d, d)
            gain(b + f"{a}.norm_q.scale", d)
            gain(b + f"{a}.norm_k.scale", d)
        lin(b + "ffn.fc1", d, ffn)
        lin(b + "ffn.fc2", ffn, d)
        specs[b + "modulation"] = ((6, d), 1.0 / math.sqrt(d), 0.0)
        gain(b + "norm3.scale", d)
        specs[b + "norm3.bias"] = ((d,), 0.01, 0.0)
    lin("head.head", d, cfg["out_dim"] * pt)
    specs["head.modulation"] = ((2, d), 1.0 / math.sqrt(d), 0.0)
    return specs


def vae_specs(cfg: dict) -> Dict[str, Spec]:
    """The decoder of Wan2.1's VAE, its 1x1x1 ``conv2`` in front."""
    specs: Dict[str, Spec] = {}

    def conv(name, c_in, c_out, k):
        fan = c_in * math.prod(k)
        specs[name + ".w"] = ((c_out, c_in) + tuple(k), 1.0 / math.sqrt(fan), 0.0)
        specs[name + ".b"] = ((c_out,), 0.01, 0.0)

    def gain(name, n):
        specs[name] = ((n,), 0.05, 1.0)

    def res(name, c_in, c_out):
        gain(name + ".norm1", c_in)
        conv(name + ".conv1", c_in, c_out, (3, 3, 3))
        gain(name + ".norm2", c_out)
        conv(name + ".conv2", c_out, c_out, (3, 3, 3))
        if c_in != c_out:
            conv(name + ".shortcut", c_in, c_out, (1, 1, 1))

    mult = cfg["dim_mult"]
    dims = [cfg["dim"] * u for u in (mult[-1],) + tuple(reversed(mult))]
    ups = list(reversed(cfg["temperal_downsample"]))
    z = cfg["z_dim"]
    conv("conv2", z, z, (1, 1, 1))
    conv("decoder.conv1", z, dims[0], (3, 3, 3))
    res("decoder.middle.0", dims[0], dims[0])
    gain("decoder.middle.1.norm", dims[0])
    conv("decoder.middle.1.qkv", dims[0], 3 * dims[0], (1, 1))
    conv("decoder.middle.1.proj", dims[0], dims[0], (1, 1))
    res("decoder.middle.2", dims[0], dims[0])
    bi = 0
    for i in range(len(mult)):
        in_dim = dims[i] // 2 if i >= 1 else dims[i]
        out_dim = dims[i + 1]
        for _ in range(cfg["num_res_blocks"] + 1):
            res(f"decoder.upsamples.{bi}", in_dim, out_dim)
            in_dim = out_dim
            bi += 1
        if i != len(mult) - 1:
            conv(f"decoder.upsamples.{bi}.conv", out_dim, out_dim // 2, (3, 3))
            if ups[i]:
                conv(f"decoder.upsamples.{bi}.time_conv", out_dim, 2 * out_dim, (3, 1, 1))
            bi += 1
    gain("decoder.head_norm", dims[-1])
    conv("decoder.head_conv", dims[-1], 3, (3, 3, 3))
    return specs


def make_weights(specs: Dict[str, Spec], seed: int, salt: int, dtype, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(_mix(seed, salt))
    return _nest(_flat_tree(specs, dtype, device, gen))


def make_vae(cfg: dict, seed: int, dtype, device) -> dict:
    w = make_weights(vae_specs(cfg), seed, 2, dtype, device)
    w["mean"] = torch.tensor(WAN_LATENT_MEAN[:cfg["z_dim"]], dtype=torch.float32, device=device)
    w["std"] = torch.tensor(WAN_LATENT_STD[:cfg["z_dim"]], dtype=torch.float32, device=device)
    return w


def _mix(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed (any size) and a salt."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_mix(seed, salt))


def prompt_embeds(cfg: dict, seed: int, salt: int, dtype, device) -> torch.Tensor:
    """One prompt's text features [1, text_len, text_dim]: a seeded valid
    length in [16, 128) (what umT5 gives a sentence), zero rows after it."""
    gen = generator(seed, salt, device)
    n = cfg["text_len"]
    valid = 16 + int(torch.randint(0, 112, (1,), generator=gen, device=device).item())
    e = torch.randn((1, n, cfg["text_dim"]), generator=gen, device=device, dtype=torch.float32)
    e[:, valid:] = 0
    return e.to(dtype)


def copy_tree(tree, fn: Callable = lambda t: t):
    """The tree's structure copied (dicts, lists), its leaves through ``fn``."""
    if isinstance(tree, dict):
        return {k: copy_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [copy_tree(v, fn) for v in tree]
    return tree if tree is None else fn(tree)


def program_dit(raw: dict, dit_cfg) -> dict:
    """The program's DiT parameters: its set-up's q/k channel order
    (``canonicalize_rope_layout``) on a copy of the structure."""
    from longlive_torch.models.dit import canonicalize_rope_layout

    return canonicalize_rope_layout(copy_tree(raw), dit_cfg)


def program_vae(raw: dict) -> dict:
    """The program's VAE parameters: its packed conv weights
    (``pack_fused_weights``) beside the raw ones, on a copy of the structure."""
    from longlive_torch.models.vae import pack_fused_weights

    p = copy_tree(raw)
    p["decoder"] = pack_fused_weights(p["decoder"])
    return p
