"""Int8 linears of the DiT blocks: dynamic per-row activation quantization
times static per-output-channel weight quantization, an exact integer
product and a float32 rescale.

  y = round_to_x_dtype((q(x) @ q(W)^T) * s_x * s_W + b)
  q(x): int8, per-row scale s_x (dynamic); q(W): int8, per-row-of-W scale
  s_W (static, made once by ``quantize_dit_params``)

Quantized linears are ``{"w_int8": [out, in] int8 (in contiguous),
"w_scale": [out] float32, "bias": [out]}``; ``models.nn.linear`` dispatches
on ``w_int8``.  Two routes compute them:

- ``linear_int8``: the activations are quantized in a separate pass and
  multiplied by ``int_matmul`` (``torch._int_mm`` on CUDA);
- ``linear_int8_fused`` (``LONGLIVE_INT8_FUSED`` set and not ``0``, read
  by ``models.nn.linear`` at call time as in the JAX package): K5,
  the hand-written Hopper kernels of ``csrc/int8_linear.cu`` (a pass that
  quantizes each row of x once, then an s8 GEMM with the rescale in its
  epilogue), one call and one count.  Its shape rule is the JAX
  package's: ``w`` 2-D, K <= 4096, K % 128 == 0 and M >= 256; other shapes
  take ``linear_int8``.  On a CPU tensor it runs
  ``linear_int8_fused_plain``, the kernel's arithmetic in PyTorch.

The two routes quantize x with different formulas and may differ by one
int8 step at some elements: ``linear_int8`` divides by the clamped scale
``max(amax / 127, 1e-8)``; K5 multiplies by ``127 / max(amax, 1e-8)``.
Both round half to even and clip to [-127, 127].

Divisions by a constant are written as tensor / tensor: PyTorch computes
``tensor / python_float`` on CUDA, and ``python_float / tensor`` anywhere,
as a product with a reciprocal, which rounds differently from the JAX
package's division.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from . import kernels

# kernel launches of linear_int8_fused since the last reset (K5), and calls
# of the separate-quantize route linear_int8 (no kernel of this repository;
# the block linears the shape rule sends there, e.g. fc2 with K = 8960)
launches = 0
linear_int8_calls = 0


def reset_launches() -> None:
    global launches, linear_int8_calls
    launches = 0
    linear_int8_calls = 0


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b, one float32 division (a python-float divisor would be a
    multiply by its reciprocal on CUDA)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _rdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """a / b, one float32 division (``a / tensor`` is ``a * (1 / tensor)``
    in PyTorch)."""
    return torch.full((), a, dtype=b.dtype, device=b.device) / b


def quantize_weight(weight: torch.Tensor) -> Dict[str, torch.Tensor]:
    """weight [..., out, in] -> {"w_int8": [..., out, in] int8, "w_scale":
    [..., out] float32}: s = max(max|w_row| / 127, 1e-8),
    q = clip(round(w / s), -127, 127)."""
    wf = weight.float()
    scale = torch.clamp_min(_div(wf.abs().amax(dim=-1, keepdim=True), 127.0), 1e-8)
    w = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_int8": w.contiguous(), "w_scale": scale.squeeze(-1).contiguous()}


def quantize_activations(x: torch.Tensor):
    """x [..., in] -> (int8 x, per-row scale [..., 1] float32), the scales
    and rounding of ``quantize_weight`` per row."""
    xf = x.float()
    scale = torch.clamp_min(_div(xf.abs().amax(dim=-1, keepdim=True), 127.0), 1e-8)
    xq = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return xq, scale


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact a @ w.T of int8 a [M, K] and int8 w [N, K]: int32 through
    ``torch._int_mm`` on CUDA (rows padded to 17 when M <= 16, which it
    does not take), int64 on the CPU.  Never float32: the sums reach ~1e8,
    past float32's exact integers."""
    if a.device.type == "cuda":
        m = a.shape[0]
        if m <= 16:
            a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
        return torch._int_mm(a.contiguous(), w.t())[:m]
    return a.long() @ w.long().t()


def linear_int8(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The separate-quantize route: ``quantize_activations``, the exact
    integer product, then (acc * s_x) * s_W (+ bias) in float32, rounded
    once to x's dtype."""
    global linear_int8_calls
    linear_int8_calls += 1
    lead = x.shape[:-1]
    xq, sx = quantize_activations(x.reshape(-1, x.shape[-1]))
    acc = int_matmul(xq, p["w_int8"])
    y = acc.float() * sx * p["w_scale"].float()
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y.to(x.dtype).reshape(*lead, -1)


_QUANT_KEYS = ("self_attn", "cross_attn", "ffn")


def quantize_dit_params(params: dict) -> dict:
    """The block linears (self- and cross-attention q, k, v, o and the FFN)
    of a DiT parameter dict as int8; everything else is shared with
    ``params``.  Returns a new dict."""
    blocks = []
    for blk in params["blocks"]:
        blk = dict(blk)
        for key in _QUANT_KEYS:
            grp = dict(blk[key])
            for name, p in grp.items():
                if isinstance(p, dict) and "weight" in p:
                    q = quantize_weight(p["weight"])
                    if p.get("bias") is not None:
                        q["bias"] = p["bias"]
                    grp[name] = q
            blk[key] = grp
        blocks.append(blk)
    return dict(params, blocks=blocks)


def fuse_qkv_params(params: dict) -> dict:
    """Serving transform: each layer's self-attention q, k, v linears
    become one ``qkv`` linear ([3 out, in]), so the block's activations are
    read (and, int8, quantized) once.  Exact: every output row keeps its
    weights and its scale.  Works on bf16 and int8 linears; apply after the
    rope permutation.  Returns a new dict."""
    blocks = []
    for blk in params["blocks"]:
        sa = dict(blk["self_attn"])
        if "qkv" not in sa and "q" in sa:
            parts = [sa.pop(n) for n in ("q", "k", "v")]
            sa["qkv"] = {key: torch.cat([p[key] for p in parts]).contiguous()
                         for key in parts[0] if parts[0][key] is not None}
        blocks.append(dict(blk, self_attn=sa))
    return dict(params, blocks=blocks)


def slice_linear(p: dict, lo: int, hi: int) -> dict:
    """Output rows [lo, hi) of a bf16 or int8 linear (views; rows of a
    contiguous weight stay contiguous)."""
    return {k: v[lo:hi] for k, v in p.items() if v is not None}


def quantize_rows_plain(x2: torch.Tensor):
    """K5's quantize pass on x [M, K]: per row, amax = max(max|x|, 1e-8) in
    float32, r = 127 / amax, xq = clip(round(x * r), -127, 127) int8 and
    s_x = amax * (1/127) float32 [M]."""
    xf = x2.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8)
    xq = torch.clamp(torch.round(xf * _rdiv(127.0, amax)), -127, 127).to(torch.int8)
    return xq, (amax * (1.0 / 127.0)).squeeze(-1)


def linear_int8_fused_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """K5's arithmetic: ``quantize_rows_plain``, then y = (acc * s_x) * s_W
    (+ bias) in float32, rounded once to x's dtype."""
    lead = x.shape[:-1]
    xq, sx = quantize_rows_plain(x.reshape(-1, x.shape[-1]))
    y = int_matmul(xq, p["w_int8"]).float() * sx[:, None] * p["w_scale"].float()
    if p.get("bias") is not None:
        y = y + p["bias"].float()
    return y.to(x.dtype).reshape(*lead, -1)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    """K5's library, its entry points' argument types set once."""
    lib = kernels.load("int8_linear")
    lib.longlive_int8_linear.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
                                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.longlive_int8_quantize_rows.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                                                + [ctypes.c_void_p])
    return lib


def _check_x(x2: torch.Tensor) -> None:
    if x2.dtype != torch.bfloat16 or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError(f"linear_int8_fused: x must be contiguous, 16-byte aligned bf16, "
                         f"got {x2.dtype}")


def kernel_quantized_rows(x2: torch.Tensor):
    """(xq [M, K] int8, s_x [M] float32) as K5's quantize pass writes them
    for the GEMM, for x [M, K] bf16 on a CUDA device (K % 128 == 0, K <=
    4096): ``quantize_rows_plain``'s values, bit for bit.  Not a launch of
    ``linear_int8_fused`` (not counted)."""
    if x2.device.type != "cuda" or x2.ndim != 2 or x2.shape[1] % 128 or x2.shape[1] > 4096:
        raise ValueError("kernel_quantized_rows: x must be [M, K] on a CUDA device, "
                         "K % 128 == 0 and K <= 4096")
    _check_x(x2)
    m, k = x2.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    lib = _lib()
    rc = lib.longlive_int8_quantize_rows(x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
                                         torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.check(lib, rc, "kernel_quantized_rows")
    return xq, sx


def _int8_linear_launch(x2: torch.Tensor, w, ws, bias) -> torch.Tensor:
    """One call of the kernel library (the quantize pass, then the GEMM) on
    checked operands; returns [M, N] in x's dtype."""
    m, k = x2.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    scratch = torch.empty((m * k + 4 * m,), dtype=torch.int8, device=x2.device)  # xq, then s_x
    bias_ptr, bias_bf16 = (None, 0) if bias is None else (bias.data_ptr(),
                                                          int(bias.dtype == torch.bfloat16))
    lib = _lib()
    rc = lib.longlive_int8_linear(x2.data_ptr(), scratch.data_ptr(), w.data_ptr(), ws.data_ptr(),
                                  bias_ptr, bias_bf16, out.data_ptr(), m, n, k, _sms(x2.device),
                                  torch.cuda.current_stream(x2.device).cuda_stream)
    kernels.check(lib, rc, "linear_int8_fused")
    return out


def _fused_operands(x: torch.Tensor, p: dict):
    """(x as [M, K], w_int8, w_scale, a float32 or bf16 bias or None),
    checked for the kernel: anything it does not take raises ValueError."""
    w = p["w_int8"]
    n, k = w.shape
    x2 = x.reshape(-1, k)
    _check_x(x2)
    ws = p["w_scale"]
    bias = p.get("bias")
    if bias is not None and bias.dtype not in (torch.float32, torch.bfloat16):
        bias = bias.float()
    if w.dtype != torch.int8 or not w.is_contiguous() or w.data_ptr() % 16 or n % 8:
        raise ValueError(f"linear_int8_fused: w_int8 must be contiguous, 16-byte aligned "
                         f"int8 [N, K] with N % 8 == 0, got {w.dtype} {tuple(w.shape)}")
    if ws.dtype != torch.float32 or ws.shape != (n,) or not ws.is_contiguous():
        raise ValueError(f"linear_int8_fused: w_scale must be contiguous float32 [{n}]")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"linear_int8_fused: bias must be [{n}]")
        bias = bias.contiguous()
    for name, t in (("w_int8", w), ("w_scale", ws), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"linear_int8_fused: {name} is on {t.device}, x on {x.device}")
    return x2, w, ws, bias


def linear_int8_fused(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The int8 linear with the activation quantize inside the kernel
    (K5).  Shapes outside the JAX package's rule for its kernel (w 2-D,
    K <= 4096, K % 128 == 0, M >= 256) take ``linear_int8``.  CPU tensors
    run the plain version.  CUDA tensors launch the kernel (its quantize
    pass, then its GEMM), which takes a bf16 x, contiguous int8 [N, K]
    weights with N % 8 == 0, float32 scales and a float32 or bf16 bias
    (read as its float32 value); anything else raises ValueError."""
    w = p["w_int8"]
    k = w.shape[-1]
    if w.ndim != 2 or k > 4096 or k % 128 or math.prod(x.shape[:-1]) < 256:
        return linear_int8(x, p)
    if x.device.type == "cpu":
        return linear_int8_fused_plain(x, p)
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"linear_int8_fused: unsupported device {x.device}")
    x2, w, ws, bias = _fused_operands(x, p)
    out = _int8_linear_launch(x2, w, ws, bias)
    launches += 1
    return out.reshape(*x.shape[:-1], w.shape[0])
