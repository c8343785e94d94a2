"""3D factorized rotary position embeddings for the Wan DiT.

head_dim d is split into 3 groups of complex pairs sized
[c - 2*(c//3), c//3, c//3] with c = d//2 (22, 21, 21 at d = 128) for the
(frame, h, w) axes.  Each token at grid position (f, h, w) is rotated by
exp(i * pos * theta^(-2j/dim_g)) per group; the frame position is absolute
(``start_frame``), so positions keep growing while the KV cache rolls.
Angle tables are built in float64 with numpy, the rotation runs in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _rope_cos_sin(max_seq_len: int, dim: int, theta: float = 10000.0):
    inv = 1.0 / np.power(theta, np.arange(0, dim, 2, dtype=np.float64) / dim)
    ang = np.outer(np.arange(max_seq_len, dtype=np.float64), inv)
    return np.cos(ang), np.sin(ang)


@dataclasses.dataclass(frozen=True)
class RopeTables:
    """Per-axis rotation tables [max_pos, c_axis] float32."""

    cos_f: torch.Tensor
    sin_f: torch.Tensor
    cos_h: torch.Tensor
    sin_h: torch.Tensor
    cos_w: torch.Tensor
    sin_w: torch.Tensor


def make_rope_tables(head_dim: int = 128, max_pos: int = 1024,
                     theta: float = 10000.0, device="cpu") -> RopeTables:
    c = head_dim // 2
    c_h = c // 3
    c_f = c - 2 * c_h
    cf, sf = _rope_cos_sin(max_pos, 2 * c_f, theta)
    ch, sh = _rope_cos_sin(max_pos, 2 * c_h, theta)
    cw, sw = _rope_cos_sin(max_pos, 2 * c_h, theta)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return RopeTables(f32(cf), f32(sf), f32(ch), f32(sh), f32(cw), f32(sw))


def rope_multipliers(tables: RopeTables, f: int, h: int, w: int,
                     start_frame: int = 0):
    """Per-token (cos, sin) [f*h*w, head_dim//2] for ``f`` frames starting
    at absolute frame ``start_frame`` over an ``h`` x ``w`` grid."""
    s = int(start_frame)
    cf, sf = tables.cos_f[s:s + f], tables.sin_f[s:s + f]
    ch, sh = tables.cos_h[:h], tables.sin_h[:h]
    cw, sw = tables.cos_w[:w], tables.sin_w[:w]

    def grid_cat(af, ah, aw):
        parts = [
            af[:, None, None, :].expand(f, h, w, af.shape[-1]),
            ah[None, :, None, :].expand(f, h, w, ah.shape[-1]),
            aw[None, None, :, :].expand(f, h, w, aw.shape[-1]),
        ]
        return torch.cat(parts, dim=-1).reshape(f * h * w, -1)

    return grid_cat(cf, ch, cw), grid_cat(sf, sh, sw)


def halfsplit_qk_perm(head_dim: int, num_heads: int = 1) -> np.ndarray:
    """Gather indices turning interleaved complex pairs (re0, im0, re1, ...)
    into (re0..re_{c-1}, im0..im_{c-1}) within each head:
    ``x_new[j] = x[perm[j]]``."""
    g = np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])
    return np.concatenate([h * head_dim + g for h in range(num_heads)])


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 premul: torch.Tensor | None = None,
                 layout: str = "interleaved") -> torch.Tensor:
    """Rotates ``x`` [B, S, N, D] by per-token (cos, sin) [S, D//2].

    ``premul`` (broadcastable to [B, S, N*D]) is an elementwise factor
    applied in float32 before the rotation: the q/k RMS-norm scale, fused so
    that no bf16 rounding sits between the norm and the rotation."""
    orig_dtype = x.dtype
    b, s, n, d = x.shape
    xf = x.float()
    if premul is not None:
        xf = xf * premul.float().reshape(b, s, n, d)
    c = cos[None, :, None, :]
    si = sin[None, :, None, :]
    if layout == "halfsplit":
        xr, xi = xf[..., : d // 2], xf[..., d // 2:]
        out = torch.cat([xr * c - xi * si, xr * si + xi * c], dim=-1)
        return out.to(orig_dtype)
    if layout != "interleaved":
        raise ValueError(f"unknown rope layout {layout!r}")
    xf = xf.reshape(b, s, n, d // 2, 2)
    xr, xi = xf[..., 0], xf[..., 1]
    out = torch.stack([xr * c - xi * si, xr * si + xi * c], dim=-1)
    return out.reshape(b, s, n, d).to(orig_dtype)
