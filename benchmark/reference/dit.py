"""Plain float32 reference of the Wan2.1 DiT, written from the published
model (Wan2.1's ``WanModel``) and LongLive's causal inference.

It imports torch only: nothing of the program under test.  Weights come as
the benchmark made them (``benchmark.weights``), in the published layout:
linears ``{"weight": [out, in], "bias": [out]}``, q/k features in Wan's
interleaved complex pairs.  Every product runs in float32 with TF32 off
(``no_tf32``), the schedule in float64.

- ``causal_forward``: one forward over a block of frames at absolute frame
  ``start``, attending per layer a context of K/V (already roped) plus the
  block's own K/V; returns the flow and the block's K/V of every layer (the
  commit's product).  LongLive's KV-recache is ``causal_forward`` over the
  replayed frames with an empty context.
- ``bidirectional_forward``: Wan2.1's text-to-video forward, one timestep
  per sample, full attention over every token.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

KV = Tuple[torch.Tensor, torch.Tensor]


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def fp8_tensor(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (amax to 448),
    as an fp8 GEMM's operands are scaled."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Operands:
    """How matmul operands are rounded: not at all (the reference), or to
    float8 e4m3 with a scale per tensor (the correctness control of a cell
    whose program has no lower-precision path: the reference one precision
    step below bf16)."""

    fp8 = False

    @classmethod
    def round(cls, x: torch.Tensor) -> torch.Tensor:
        return fp8_tensor(x) if cls.fp8 else x


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = Operands.round(x) @ Operands.round(f32(p["weight"])).t()
    return y + f32(p["bias"]) if p.get("bias") is not None else y


def layer_norm(x: torch.Tensor, eps: float, scale=None, bias=None) -> torch.Tensor:
    y = F.layer_norm(x, x.shape[-1:], eps=eps)
    if scale is not None:
        y = y * f32(scale) + f32(bias)
    return y


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * f32(w)


def sinusoid(dim: int, t: torch.Tensor) -> torch.Tensor:
    """Wan's sinusoidal_embedding_1d: [cos | sin], in float64 then float32."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64, device=t.device) / half)
    a = t.double()[:, None] * freqs
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1).float()


def rope_angles(head_dim: int, f0: int, nf: int, h: int, w: int, device,
                theta: float = 10000.0) -> torch.Tensor:
    """Angles [nf*h*w, head_dim/2] of Wan's 3-D RoPE: the complex pairs
    split [c - 2(c//3), c//3, c//3] over (frame, height, width), frame
    positions absolute from ``f0``."""
    c = head_dim // 2
    ch = c // 3
    cf = c - 2 * ch

    def inv(n):
        return 1.0 / torch.pow(theta, torch.arange(0, 2 * n, 2, dtype=torch.float64,
                                                    device=device) / (2 * n))

    pf = torch.arange(f0, f0 + nf, dtype=torch.float64, device=device)
    ph = torch.arange(h, dtype=torch.float64, device=device)
    pw = torch.arange(w, dtype=torch.float64, device=device)
    af = (pf[:, None] * inv(cf))[:, None, None, :].expand(nf, h, w, cf)
    ah = (ph[:, None] * inv(ch))[None, :, None, :].expand(nf, h, w, ch)
    aw = (pw[:, None] * inv(ch))[None, None, :, :].expand(nf, h, w, ch)
    return torch.cat([af, ah, aw], dim=-1).reshape(nf * h * w, c)


def apply_rope(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [B, S, N, D] with interleaved (re, im) pairs, rotated by ang [S, D/2]."""
    b, s, n, d = x.shape
    xc = torch.view_as_complex(x.double().reshape(b, s, n, d // 2, 2).contiguous())
    rot = torch.polar(torch.ones_like(ang), ang)[None, :, None, :]
    return torch.view_as_real(xc * rot).reshape(b, s, n, d).float()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              max_elems: int = 1 << 28) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v for q [B, Sq, N, D], k, v [B, Sk, N, D],
    head by head, in query chunks of at most ``max_elems`` logits."""
    q, k, v = Operands.round(q), Operands.round(k), Operands.round(v)
    b, sq, n, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    rows = max(1, min(sq, max_elems // sk))
    scale = 1.0 / math.sqrt(d)
    for bi in range(b):
        for hi in range(n):
            kh, vh = k[bi, :, hi], v[bi, :, hi]
            for r0 in range(0, sq, rows):
                logits = (q[bi, r0:r0 + rows, hi] @ kh.t()) * scale
                out[bi, r0:r0 + rows, hi] = Operands.round(torch.softmax(logits, dim=-1)) @ vh
    return out


def patchify(x: torch.Tensor, patch: Sequence[int]) -> torch.Tensor:
    """[B, F, C, H, W] -> [B, F*(H/2)*(W/2), C*2*2] (Wan's patch conv as a linear)."""
    _, ph, pw = patch
    b, f, c, h, w = x.shape
    x = x.reshape(b, f, c, h // ph, ph, w // pw, pw).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, f * (h // ph) * (w // pw), c * ph * pw)


def unpatchify(y: torch.Tensor, patch: Sequence[int], out_dim: int, f: int, h: int,
               w: int) -> torch.Tensor:
    """Wan's unpatchify: features ordered (pt, ph, pw, c)."""
    _, ph, pw = patch
    b = y.shape[0]
    y = y.reshape(b, f, h // ph, w // pw, ph, pw, out_dim)
    return y.permute(0, 1, 6, 2, 4, 3, 5).reshape(b, f, out_dim, h, w)


def text_context(W: dict, emb: torch.Tensor) -> torch.Tensor:
    p = W["text_embedding"]
    return linear(F.gelu(linear(emb.float(), p["fc1"]), approximate="tanh"), p["fc2"])


def cross_kv(W: dict, cfg: dict, ctx: torch.Tensor) -> List[KV]:
    """Each layer's cross-attention K (RMS-normed) and V [B, T, N, D]."""
    n = cfg["num_heads"]
    b, s, d = ctx.shape
    out = []
    for blk in W["blocks"]:
        ca = blk["cross_attn"]
        k = rms_norm(linear(ctx, ca["k"]), ca["norm_k"]["scale"], cfg["eps"])
        out.append((k.reshape(b, s, n, d // n), linear(ctx, ca["v"]).reshape(b, s, n, d // n)))
    return out


def time_embedding(W: dict, cfg: dict, t: torch.Tensor):
    """t [M] -> (e [M, dim], e0 [M, 6, dim])."""
    te = W["time_embedding"]
    e = linear(F.silu(linear(sinusoid(cfg["freq_dim"], t), te["fc1"])), te["fc2"])
    e0 = linear(F.silu(e), W["time_projection"]["fc"]).reshape(-1, 6, cfg["dim"])
    return e, e0


def self_attention(blk: dict, cfg: dict, h: torch.Tensor, ang: torch.Tensor,
                   context: Optional[KV]):
    """A block's self-attention on its modulated input h [B, S, dim]:
    (the attention's output [B, S, N, D] before the output projection, the
    projection, the block's roped K and V)."""
    b, s, d = h.shape
    n, eps = cfg["num_heads"], cfg["eps"]
    sa = blk["self_attn"]
    k = apply_rope(rms_norm(linear(h, sa["k"]), sa["norm_k"]["scale"], eps).reshape(b, s, n, -1),
                   ang)
    v = linear(h, sa["v"]).reshape(b, s, n, -1)
    q = apply_rope(rms_norm(linear(h, sa["q"]), sa["norm_q"]["scale"], eps).reshape(b, s, n, -1),
                   ang)
    kk, vv = (k, v) if context is None else (torch.cat([context[0], k], 1),
                                             torch.cat([context[1], v], 1))
    a = attention(q, kk, vv)
    return a, linear(a.reshape(b, s, d), sa["o"]), k, v


def layer_parts(blk: dict, cfg: dict, x: torch.Tensor, mod: torch.Tensor, ang: torch.Tensor,
                context: Optional[KV], cross: KV, kv_only: bool = False,
                given: Optional[dict] = None, dtype=None) -> dict:
    """One Wan block from its input x [B, S, dim]; mod [B, S or 1, 6, dim]
    (the block's modulation already added); ``context`` the earlier tokens'
    roped K/V, attended before the block's own.  Returns the block's parts:
    ``k``, ``v`` (roped), and unless ``kv_only`` ``a`` (the self-attention
    before its output projection), ``y`` (after it), ``cq``, ``co`` (the
    cross-attention's query and output before its projection), ``c``
    (after it), ``f`` (the FFN before its gate) and ``out``.

    ``given`` {"y", "c", "f"}: parts computed elsewhere (the program's),
    which then carry the residual stream in place of the block's own, so
    that each part is computed from the input the other side gave it, and
    the glue around the parts (gates, norms, sums) is this block's; each
    sum is rounded to ``dtype``, as a model holds its residual stream."""
    b, s, d = x.shape
    n = cfg["num_heads"]
    eps = cfg["eps"]
    m = [mod[:, :, i] for i in range(6)]
    given = given or {}

    def held(t):
        return t if dtype is None else t.to(dtype).float()

    def carry(name, t):
        return given[name].float() if name in given else t

    h = layer_norm(x, eps) * (1 + m[1]) + m[0]
    if kv_only:
        sa = blk["self_attn"]
        k = rms_norm(linear(h, sa["k"]), sa["norm_k"]["scale"], eps).reshape(b, s, n, -1)
        return {"k": apply_rope(k, ang), "v": linear(h, sa["v"]).reshape(b, s, n, -1)}
    a, y, k, v = self_attention(blk, cfg, h, ang, context)
    x = _glue(x, m, "y", carry("y", y), held)
    h = layer_norm(x, eps, blk["norm3"]["scale"], blk["norm3"]["bias"])
    ca = blk["cross_attn"]
    cq = rms_norm(linear(h, ca["q"]), ca["norm_q"]["scale"], eps).reshape(b, s, n, -1)
    co = attention(cq, cross[0], cross[1])
    c = linear(co.reshape(b, s, d), ca["o"])
    x = _glue(x, m, "c", carry("c", c), held)
    h = layer_norm(x, eps) * (1 + m[4]) + m[3]
    ffn = blk["ffn"]
    f = linear(F.gelu(linear(h, ffn["fc1"]), approximate="tanh"), ffn["fc2"])
    out = _glue(x, m, "f", carry("f", f), held)
    return {"a": a, "y": y, "cq": cq, "co": co, "c": c, "f": f, "k": k, "v": v, "out": out}


def _glue(x: torch.Tensor, m: list, part: str, value: torch.Tensor, held) -> torch.Tensor:
    """The residual stream after a part: the self-attention and the FFN
    gated (modulation 2 and 5), the cross-attention added as it is."""
    gate = {"y": 2, "c": None, "f": 5}[part]
    return held(x + (value if gate is None else held(value * m[gate])))


def residual(x: torch.Tensor, mod: torch.Tensor, given: dict, dtype=None) -> torch.Tensor:
    """A block's output from its input x and the parts ``given`` ({"y",
    "c", "f"}): ``layer_parts``'s glue alone, each sum rounded to
    ``dtype``."""
    m = [mod[:, :, i] for i in range(6)]

    def held(t):
        return t if dtype is None else t.to(dtype).float()

    for part in ("y", "c", "f"):
        x = _glue(x, m, part, given[part].float(), held)
    return x


def _layer(blk: dict, cfg: dict, x: torch.Tensor, mod: torch.Tensor, ang: torch.Tensor,
           context: Optional[KV], cross: KV, kv_only: bool = False, record=None):
    """One Wan block (``layer_parts``): (x or None, k, v, the
    self-attention's output projection or None).  ``record`` (a dict) gets
    the block's input and its parts ``y``, ``c``, ``f``, as the harness
    records the program's."""
    r = layer_parts(blk, cfg, x, mod, ang, context, cross, kv_only)
    if record is not None and not kv_only:
        record.update(x_in=x, y=r["y"], c=r["c"], f=r["f"])
    return r.get("out"), r["k"], r["v"], r.get("y")


def _head(W: dict, cfg: dict, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """e [B, S or 1, dim] -> head output [B, S, out*4]."""
    em = f32(W["head"]["modulation"])[None, None] + e[:, :, None]
    h = layer_norm(x, cfg["eps"]) * (1 + em[:, :, 1]) + em[:, :, 0]
    return linear(h, W["head"]["head"])


def causal_forward(W: dict, cfg: dict, x: torch.Tensor, t: float, start: int,
                   context: Optional[List[KV]], cross: List[KV],
                   kv_only: bool = False) -> Tuple[Optional[torch.Tensor], List[KV]]:
    """One cached forward of LongLive's causal generator over the frames
    [start, start + F) of x [B, F, C, H, W] at timestep ``t``.  Layer l
    attends ``context[l]`` (roped K/V of the frames in its window, or None)
    plus the block's own K/V.  Returns (flow [B, F, C, H, W], or None with
    ``kv_only``, which skips the last layer's attention and the head; the
    block's K/V of every layer)."""
    b, f, c, h, w = x.shape
    patch = cfg["patch_size"]
    hp, wp = h // patch[1], w // patch[2]
    tok = linear(patchify(x.float(), patch), W["patch_embedding"])
    e, e0 = time_embedding(W, cfg, torch.full((1,), float(t), device=x.device))
    ang = rope_angles(cfg["dim"] // cfg["num_heads"], start, f, hp, wp, x.device)
    kvs = []
    nl = len(W["blocks"])
    for li, blk in enumerate(W["blocks"]):
        mod = (f32(blk["modulation"])[None] + e0)[:, None]  # [1, 1, 6, dim]
        last = kv_only and li == nl - 1
        out, k, v, _ = _layer(blk, cfg, tok, mod, ang, None if context is None else context[li],
                              cross[li], kv_only=last)
        kvs.append((k, v))
        if not last:
            tok = out
    if kv_only:
        return None, kvs
    y = _head(W, cfg, tok, e[:, None])
    return unpatchify(y, patch, cfg["out_dim"], f, h, w), kvs


def bidirectional_forward(W: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor,
                          cross: List[KV], record: Optional[dict] = None) -> torch.Tensor:
    """Wan2.1 t2v forward: x [B, F, C, H, W], t [B] -> flow [B, F, C, H, W];
    ``cross`` per layer [B, T, N, D].  ``record`` {layer: {}}: those layers'
    parts (``_layer``)."""
    b, f, c, h, w = x.shape
    patch = cfg["patch_size"]
    hp, wp = h // patch[1], w // patch[2]
    tok = linear(patchify(x.float(), patch), W["patch_embedding"])
    e, e0 = time_embedding(W, cfg, t)
    ang = rope_angles(cfg["dim"] // cfg["num_heads"], 0, f, hp, wp, x.device)
    for li, blk in enumerate(W["blocks"]):
        mod = (f32(blk["modulation"])[None] + e0)[:, None]  # [B, 1, 6, dim]
        rec = None if record is None else record.get(li)
        tok = _layer(blk, cfg, tok, mod, ang, None, cross[li], record=rec)[0]
    y = _head(W, cfg, tok, e[:, None])
    return unpatchify(y, patch, cfg["out_dim"], f, h, w)
