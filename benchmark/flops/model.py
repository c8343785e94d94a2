"""Operations and bytes of the work the benchmark's cells run, counted
from the model's shapes, whatever implements them.

Operations are multiply-adds times two.  Attention counts valid keys only:
4 Sq Skv dim for QK^T and PV.  A kernel's bytes count each input read once
and each output written once, in its dtype.  ``Work`` adds up by name:
``model`` (every operation of the model: linears, attention, convs),
``k1`` (the attention kernel's operations, ``k1_bytes``, ``k1_calls``,
``k1_least_s``: the sum over calls of the larger of operations / peak and
bytes / bandwidth), ``k2`` likewise for the VAE's fused causal convs.
"""

from __future__ import annotations

import collections
import math

PEAK_BF16 = 989e12  # NVIDIA H100 SXM, dense bf16 FLOP/s
PEAK_BW = 3.35e12  # HBM3 bytes/s
BF16 = 2


class Work(collections.Counter):
    """Float counters keyed by name; ``+`` adds."""

    def add_kernel(self, name: str, ops: float, nbytes: float, calls: int = 1) -> None:
        self[name] += ops
        self[name + "_bytes"] += nbytes
        self[name + "_calls"] += calls
        self[name + "_least_s"] += calls * max(ops / calls / PEAK_BF16,
                                               nbytes / calls / PEAK_BW) if calls else 0.0


def attention_ops(sq: int, skv: int, dim: int) -> float:
    return 4.0 * sq * skv * dim


def k1_call(w: Work, b: int, sq: int, skv: int, dim: int, model: bool = True) -> None:
    """One attention kernel call: q, k, v, out in bf16 and a float32 bias row
    per batch row; ``model``: its operations count in the model's too."""
    ops = b * attention_ops(sq, skv, dim)
    nbytes = b * ((2 * sq * dim + 2 * skv * dim) * BF16 + skv * 4)
    w.add_kernel("k1", ops, nbytes)
    if model:
        w["model"] += ops


def dit_linear_ops(cfg: dict, tokens: int, kv_only_last: bool = False) -> float:
    """The linears of one forward over ``tokens`` query tokens (the
    cross-attention's K/V come with the prompt, once): per layer q, k, v, o,
    the cross q, o, the FFN; the patch embedding and the head.  A commit's
    last layer computes only its k, v."""
    d, f, n = cfg["dim"], cfg["ffn_dim"], cfg["num_layers"]
    pt = math.prod(cfg["patch_size"])
    per_layer = 2.0 * tokens * (6 * d * d + 2 * d * f)
    ops = n * per_layer + 2.0 * tokens * d * pt * (cfg["in_dim"] + cfg["out_dim"])
    if kv_only_last:  # the last layer's k, v only, and no head
        ops -= per_layer - 2.0 * tokens * 2 * d * d + 2.0 * tokens * d * pt * cfg["out_dim"]
    return ops


def frame_tokens(cfg: dict) -> int:
    _, ph, pw = cfg["patch_size"]
    hl, wl = cfg["height"] // cfg["vae_stride"][1], cfg["width"] // cfg["vae_stride"][2]
    return (hl // ph) * (wl // pw)


def causal_forward(w: Work, cfg: dict, frames: int, ctx_frames: int, kv_only: bool) -> None:
    """One cached forward over ``frames`` frames attending ``ctx_frames``
    valid frames (its own included); a commit (``kv_only``) skips the last
    layer's attention."""
    t = frames * frame_tokens(cfg)
    skv = ctx_frames * frame_tokens(cfg)
    layers = cfg["num_layers"] - (1 if kv_only else 0)
    w["model"] += dit_linear_ops(cfg, t, kv_only)
    for _ in range(layers):
        k1_call(w, 1, t, skv, cfg["dim"])
        w["model"] += attention_ops(t, cfg["text_len"], cfg["dim"])  # the cross-attention


def causal_block(cfg: dict, ctx_frames: int, steps: int) -> Work:
    """One block: ``steps`` denoise forwards and the commit."""
    w = Work()
    fpb = cfg["num_frame_per_block"]
    for _ in range(steps):
        causal_forward(w, cfg, fpb, ctx_frames, False)
    causal_forward(w, cfg, fpb, ctx_frames, True)
    return w


def recache(cfg: dict, frames: int) -> Work:
    """LongLive's KV-recache: one commit-style forward over the replayed
    frames, each attending all of them, plus the new prompt's cross K/V."""
    w = Work()
    causal_forward(w, cfg, frames, frames, True)
    d = cfg["dim"]
    # the prompt's text embedding and every layer's cross K/V
    w["model"] += 2.0 * cfg["text_len"] * (cfg["text_dim"] * d + d * d
                                           + cfg["num_layers"] * 2 * d * d)
    return w


def bidirectional_step(cfg: dict, frames: int, batch: int) -> Work:
    """One guided sampler step, a forward of ``batch`` samples over every
    token: ``model`` is the whole step's operations, ``k1`` the attention
    kernel's (the self-attention, then the cross-attention over the
    prompt)."""
    w = Work()
    s = frames * frame_tokens(cfg)
    d, n = cfg["dim"], cfg["num_layers"]
    w["model"] += batch * (dit_linear_ops(cfg, s) + n * (
        attention_ops(s, s, d) + attention_ops(s, cfg["text_len"], d)))
    for _ in range(n):
        k1_call(w, batch, s, s, d, model=False)
        k1_call(w, batch, s, cfg["text_len"], d, model=False)
    return w


def _conv(w: Work, cin: int, cout: int, k, t: int, h: int, wd: int, fused: bool,
          residual: bool = False) -> None:
    kv = math.prod(k)
    ops = 2.0 * t * h * wd * cout * cin * kv
    w["model"] += ops
    if fused:
        tin = t + k[0] - 1  # the frames read: the cache and the new ones
        nbytes = BF16 * (tin * h * wd * cin + cout * cin * kv + t * h * wd * cout
                         + (t * h * wd * cout if residual else 0))
        w.add_kernel("k2", ops, nbytes)


def decode_frame(cfg: dict, vae: dict, first: bool) -> Work:
    """The decoder's operations for one latent frame (the first maps to one
    pixel frame and skips the time convs); ``k2`` counts the convs the fused
    causal-conv kernel takes (3x3x3 or 3x1x1 with both widths >= 96)."""
    w = Work()
    h, wd = cfg["height"] // cfg["vae_stride"][1], cfg["width"] // cfg["vae_stride"][2]
    mult = vae["dim_mult"]
    dims = [vae["dim"] * u for u in (mult[-1],) + tuple(reversed(mult))]
    ups = list(reversed(vae["temperal_downsample"]))
    z = vae["z_dim"]
    t = 1

    def conv3(cin, cout, k=(3, 3, 3), residual=False):
        fused = k in ((3, 3, 3), (3, 1, 1)) and cin >= 96 and cout >= 96
        _conv(w, cin, cout, k, t, h, wd, fused, residual)

    def res(cin, cout):
        conv3(cin, cout)
        conv3(cout, cout, residual=True)
        if cin != cout:
            _conv(w, cin, cout, (1, 1, 1), t, h, wd, False)

    _conv(w, z, z, (1, 1, 1), t, h, wd, False)
    conv3(z, dims[0])
    res(dims[0], dims[0])
    c = dims[0]
    w["model"] += 2.0 * t * (h * wd * 3 * c * c + 2 * (h * wd) ** 2 * c + h * wd * c * c)
    res(dims[0], dims[0])
    in_dim = dims[0]
    for i in range(len(mult)):
        out_dim = dims[i + 1]
        if i >= 1:
            in_dim //= 2
        for _ in range(vae["num_res_blocks"] + 1):
            res(in_dim, out_dim)
            in_dim = out_dim
        if i != len(mult) - 1:
            if ups[i] and not first:
                conv3(out_dim, 2 * out_dim, (3, 1, 1))
                t *= 2
            h, wd = 2 * h, 2 * wd
            _conv(w, out_dim, out_dim // 2, (1, 3, 3), t, h, wd, False)
    conv3(dims[-1], 3)
    return w
