"""The causal serving loop: LongLive's live stream, with live prompt
switches where the traffic mix posts them.

It composes the calls ``longlive_torch.pipeline.PipelinedRenderer.render``
composes, one segment at a time on the generating card, and ships each
segment's pixels to the host as a live server does:

    [a switch: prepare_condition, then reactive_switch]
    generate_latents_scanned (the segment's blocks: 4 denoise forwards and a commit each)
    vae_decode_scan (the segment's latent frames)
    copy to the host

After the window it judges the segment that follows it against the plain
reference (``benchmark.reference``), part by part from the program's own
input to each part: every layer's self-attention, cross-attention and FFN
and the head in the block's forwards, the cache entries its commit and the
switch's recache wrote, the prompt's K/V, and the decoder's units.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import weights as WT
from .flops import model as FL
from .capture import LayerTap
from .harness import Ctx, cuda_events, elapsed_ms, sync
from .reference import dit as RD
from .reference import vae as RV
from .reference.schedule import causal_sigmas


def dit_config(cfg: dict):
    from longlive_torch.config import DiTConfig

    return DiTConfig(
        dim=cfg["dim"], ffn_dim=cfg["ffn_dim"], num_heads=cfg["num_heads"],
        num_layers=cfg["num_layers"], in_dim=cfg["in_dim"], out_dim=cfg["out_dim"],
        text_dim=cfg["text_dim"], text_len=cfg["text_len"], freq_dim=cfg["freq_dim"],
        patch_size=tuple(cfg["patch_size"]), qk_norm=cfg["qk_norm"],
        cross_attn_norm=cfg["cross_attn_norm"], eps=cfg["eps"],
        local_attn_size=cfg.get("local_attn_size", -1), sink_size=cfg.get("sink_size", 0),
        num_frame_per_block=cfg.get("num_frame_per_block", 1),
        rope_max_pos=cfg["rope_max_pos"])


def latent_hw(cfg: dict):
    return cfg["height"] // cfg["vae_stride"][1], cfg["width"] // cfg["vae_stride"][2]


def _vae_config(v: dict):
    from longlive_torch.models.vae import VAEConfig

    return VAEConfig(dim=v["dim"], z_dim=v["z_dim"], dim_mult=tuple(v["dim_mult"]),
                     num_res_blocks=v["num_res_blocks"],
                     temperal_downsample=tuple(v["temperal_downsample"]))


def _to_interleaved(k: torch.Tensor) -> torch.Tensor:
    """The program's cached K keeps each head's complex pairs as (re half ++
    im half); the published order interleaves them."""
    d = k.shape[-1]
    g = torch.cat([torch.arange(0, d, 2), torch.arange(1, d, 2)]).to(k.device)
    out = torch.empty_like(k)
    out[..., g] = k
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative RMS error of a against the reference b."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))




class UnitCapture:
    """Records each top-level unit of the program's streaming VAE decoder
    (its first conv, residual blocks, attention block, upsamplers and head)
    while installed: (kind, input, the caches it consumed, output)."""

    KINDS = ("causal_conv3d", "res_block", "attention_block", "resample_up",
             "norm_silu_causal_conv")

    def __init__(self, per_frame: int, frame: int):
        self.units: List[tuple] = []
        self.per_frame, self.frame = per_frame, frame  # the one latent frame kept
        self.seen = 0
        self.orig = None

    def install(self) -> None:
        from longlive_torch.models import vae as V

        self.orig = {k: getattr(V, k) for k in self.KINDS}
        depth = [0]
        units = self.units

        def wrap(kind, fn):
            def unit(x, *a, **kw):
                thread = next((t for t in a if isinstance(t, V._CacheThread)), None)
                i0 = thread.idx if thread is not None else 0
                depth[0] += 1
                try:
                    out = fn(x, *a, **kw)
                finally:
                    depth[0] -= 1
                cached = thread is not None and thread.caches is not None
                if depth[0] == 0 and (cached or kind == "attention_block"):
                    if self.seen // self.per_frame == self.frame:
                        used = [c.clone() for c in thread.caches[i0:thread.idx]] if cached else []
                        units.append((kind, x.clone(), used, out.clone(), a[2:4]))
                    self.seen += 1
                return out
            return unit

        for k, fn in self.orig.items():
            setattr(V, k, wrap(k, fn))

    def remove(self) -> None:
        from longlive_torch.models import vae as V

        if self.orig is not None:
            for k, fn in self.orig.items():
                setattr(V, k, fn)
            self.orig = None


class _Snap:
    """A copy of the program's state at one point of the window."""

    def __init__(self, cache):
        self.k = cache.k.clone()
        self.v = cache.v.clone()
        self.k_scale = None if cache.k_scale is None else cache.k_scale.clone()

    def frame_kv(self, slot: int, fs: int):
        """Layer-stacked (K, V) [L, 1, fs, N, D] float32 of one cache slot,
        K in the published channel order."""
        sl = slice(slot * fs, (slot + 1) * fs)
        k = self.k[:, :, :, sl].float()
        if self.k_scale is not None:
            k = k * self.k_scale[:, :, :, sl, None].float()
        return _to_interleaved(k).transpose(2, 3), self.v[:, :, :, sl].float().transpose(2, 3)


class LayerCapture:
    """Records every layer call of the program's cached forward
    (``models.dit._block_body``: its input and parts, ``capture.LayerTap``,
    under (layer, kv_only)) and every forward (``dit_forward_cached``: its
    timestep, flow and kv_only) while installed."""

    def __init__(self):
        from longlive_torch.models import dit as D

        self.tap = LayerTap(D, "_block_body",
                            lambda a, kw, i: (a[3], a[4], (a[12], bool(kw.get("kv_only")))))
        self.forwards: List[tuple] = []
        self.orig = None

    @property
    def calls(self) -> List[tuple]:
        return self.tap.calls

    def install(self) -> None:
        from longlive_torch.models import dit as D

        self.tap.install()
        self.orig = fwd0 = D.dit_forward_cached
        forwards = self.forwards

        def forward(params, cfg, cache_cfg, tables, x, t, *a, **kw):
            flow, cache = fwd0(params, cfg, cache_cfg, tables, x, t, *a, **kw)
            forwards.append((float(t.flatten()[0]), flow.clone(), bool(kw.get("kv_only"))))
            return flow, cache

        D.dit_forward_cached = forward

    def remove(self) -> None:
        from longlive_torch.models import dit as D

        if self.orig is not None:
            self.tap.remove()
            D.dit_forward_cached = self.orig
            self.orig = None


def _split_frames(kvs: List, f: int, fs: int) -> List[List]:
    """Per-layer block K/V [1, f*fs, N, D] -> per frame, per layer."""
    return [[(k[:, i * fs:(i + 1) * fs], v[:, i * fs:(i + 1) * fs]) for k, v in kvs]
            for i in range(f)]


class Serve:
    """One cell of the serving loop: set-up, warm-up, window, judgement."""

    def __init__(self, ctx: Ctx):
        from longlive_torch.config import LatentGeometry, PipelineConfig
        from longlive_torch.ops import quant
        from longlive_torch.pipeline import CausalInferencePipeline

        self.ctx = ctx
        c, tr = ctx.config, ctx.traffic
        self.cfg = c
        dev = ctx.device
        self.dtype = getattr(torch, c["dtype"])
        int8 = ctx.variant == "int8"
        with ctx.phase("weights"):
            self.raw = WT.make_weights(WT.dit_specs(c), ctx.seed, 1, self.dtype, dev)
            self.vraw = WT.make_vae(c["vae"], ctx.seed, self.dtype, dev)
            params = WT.program_dit(self.raw, dit_config(c))
            if int8:
                params = quant.quantize_dit_params(params)
            self.vparams = WT.program_vae(self.vraw)
            hl, wl = latent_hw(c)
            self.noise = torch.randn((1, c["num_output_frames"], c["in_dim"], hl, wl),
                                     generator=WT.generator(ctx.seed, 3, dev), device=dev)
            self.prompts = [WT.prompt_embeds(c, ctx.seed, 10 + i, self.dtype, dev)
                            for i in range(tr["prompt_pool"])]
        with ctx.phase("kernels"):
            ctx.load_kernels(["flash_attention", "causal_conv"] + (["int8_linear"] if int8 else []))
        with ctx.phase("pipeline"):
            pc = PipelineConfig(
                denoising_step_list=tuple(c["denoising_step_list"]),
                warp_denoising_step=c["warp_denoising_step"],
                num_frame_per_block=c["num_frame_per_block"],
                timestep_shift=c["timestep_shift"], local_attn_size=c["local_attn_size"],
                sink_size=c["sink_size"], num_output_frames=c["num_output_frames"],
                context_noise=c["context_noise"], global_sink=tr["global_sink"],
                kv_int8=int8)
            self.pipe = CausalInferencePipeline(
                pc, params, geometry=LatentGeometry(channels=c["in_dim"], height=hl, width=wl,
                                                    patch_size=tuple(c["patch_size"])),
                dit_config=dit_config(c), device=dev)
            self.vcfg = _vae_config(c["vae"])
            self.gen = WT.generator(ctx.seed, 5, dev)
            self.prompt_rng = np.random.default_rng(WT._mix(ctx.seed, 6))
            self.prompt = 0
            self.cross = self.pipe.prepare_condition(self.prompts[0])
        self.cache = self.vae_caches = self.hist = None
        self.pinned = None
        self.segs: List[dict] = []

    # -- one segment -----------------------------------------------------------

    def _ship(self, px: torch.Tensor) -> None:
        """Copies the segment's pixels to the host and waits for them."""
        if px.device.type != "cuda":
            self.host_px = px.clone()
            return
        if self.pinned is None or self.pinned.numel() < px.numel():
            self.pinned = torch.empty(px.numel(), dtype=px.dtype, pin_memory=True)
        self.pinned[:px.numel()].view_as(px).copy_(px, non_blocking=True)
        torch.cuda.current_stream().synchronize()

    def switch_due(self, start: int) -> bool:
        """A switch is posted at the first segment that starts at or past
        each multiple of the mix's ``switch_every`` latent frames (as a
        scheduled switch takes effect at the first block at or after its
        frame)."""
        every, n = self.ctx.traffic["switch_every"], self.ctx.traffic["segment_frames"]
        return bool(every) and start > 0 and start // every > (start - n) // every

    def segment(self, start: int, switch: bool = False, hook=None) -> dict:
        """One segment at latent frame ``start``, after a prompt switch if
        ``switch``; ``hook(stage, seg)`` sees the state before and after
        each stage (the judgement's samples)."""
        from longlive_torch.models import vae as V

        tr, c = self.ctx.traffic, self.cfg
        n = tr["segment_frames"]
        if start + n > c["num_output_frames"]:
            raise RuntimeError(f"the video ends at {c['num_output_frames']} latent frames")
        seg = {"start": start, "posted": time.perf_counter(), "switch": switch}
        ev = cuda_events(self.ctx.device, 6)
        if switch:
            choices = [i for i in range(len(self.prompts)) if i != self.prompt]
            self.prompt = int(choices[self.prompt_rng.integers(len(choices))])
            seg["prompt"] = self.prompt
            if hook:
                hook("switch", seg)
            ev[0].record()
            self.cross = self.pipe.prepare_condition(self.prompts[self.prompt])
            self.cache = self.pipe.reactive_switch(self.cache, self.hist, self.cross, start)
            ev[1].record()
        if hook:
            hook("generate", seg)
        ev[2].record()
        lat, self.cache = self.pipe.generate_latents_scanned(
            self.noise[:, start:start + n], self.cross, self.gen, self.cache, start)
        ev[3].record()
        window = c["local_attn_size"]
        self.hist = (lat if self.hist is None else torch.cat([self.hist, lat], 1))[:, -window:]
        if hook:
            hook("decode", seg, lat)
        ev[4].record()
        px, self.vae_caches = V.vae_decode_scan(self.vparams, self.vcfg, lat.to(self.dtype),
                                                self.vae_caches, start == 0)
        ev[5].record()
        self._ship(px)
        seg["shipped"] = time.perf_counter()
        seg["pixel_frames"] = px.shape[1]
        seg["latent_frames"] = n
        seg["events"] = ev
        if hook:
            hook("shipped", seg, lat, px)
        return seg

    # -- the run ---------------------------------------------------------------

    def run(self) -> dict:
        from longlive_torch.ops import attention as A
        from longlive_torch.ops import vae_conv as VC

        ctx, tr = self.ctx, self.ctx.traffic
        n = tr["segment_frames"]
        self.sampler = _Samples(self)
        start = 0
        with ctx.phase("warmup"):
            while start < tr["warmup_frames"]:
                self.segment(start, start in tr["warmup_switches"], self.sampler.warm_hook)
                start += n
            sync(ctx.device)
        ctx.setup_done()
        A.reset_launches()
        VC.reset_launches()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while not self.segs or self.segs[-1]["shipped"] < deadline:
            self.segs.append(self.segment(start, self.switch_due(start)))
            start += n
        t_end = self.segs[-1]["shipped"]
        sync(ctx.device)
        ctx.read_memory_peak()
        counters = {"k1_launches": dict(A.mode_launches), "k2_launches": dict(VC.mode_launches)}
        # after the window, the judgement's sample: the next segment of the
        # same stream, after a switch where the mix posts them
        self.segment(start, bool(tr["switch_every"]), self.sampler.take)
        start += n
        traced = []
        if ctx.trace:
            # the stream's next segments under the profiler, the device's
            # trace, then two with the host's operations
            ctx.tracer.start()
            for _ in range(tr["trace_segments"]):
                traced.append(self.segment(start, self.switch_due(start)))
                start += n
            ctx.tracer.stop()
            if ctx.device.type == "cuda":
                ctx.tracer.start(host=True)
                for _ in range(2):
                    self.segment(start, self.switch_due(start))
                    start += n
                ctx.tracer.stop()
        rec = self._record(t0, t_end, traced)
        rec["counters"] = counters
        return rec

    def _record(self, t0: float, t_end: float, traced: List[dict]) -> dict:
        c, segs = self.cfg, self.segs
        gaps, prev = [], t0
        for s in segs:
            gaps.append((s["shipped"] - prev) * 1e3)
            prev = s["shipped"]
        steps = len(c["denoising_step_list"])
        fpb = c["num_frame_per_block"]
        blocks_per_seg = self.ctx.traffic["segment_frames"] // fpb
        spans = {"gen_ms": [], "vae_ms": [], "recache_ms": []}

        def seg_work(s):
            w = FL.Work()
            for _ in range(blocks_per_seg):
                w.update(FL.causal_block(c, c["local_attn_size"], steps))
            for _ in range(s["latent_frames"]):
                w.update(FL.decode_frame(c, c["vae"], False))
            if s["switch"]:
                w.update(FL.recache(c, min(c["local_attn_size"], s["start"])))
            return w

        work, traced_work = FL.Work(), FL.Work()
        for s in segs:
            ev = s["events"]
            if s["switch"]:
                spans["recache_ms"].append(elapsed_ms(ev[0], ev[1]))
            spans["gen_ms"].append(elapsed_ms(ev[2], ev[3]))
            spans["vae_ms"].append(elapsed_ms(ev[4], ev[5]))
            work.update(seg_work(s))
        for s in traced:
            traced_work.update(seg_work(s))
        switches = [(s["shipped"] - s["posted"]) * 1e3 for s in segs if s["switch"]]
        return {
            "window_s": t_end - t0,
            "pixel_frames": sum(s["pixel_frames"] for s in segs),
            "latent_frames": sum(s["latent_frames"] for s in segs),
            "segments": len(segs),
            "traced_latent_frames": sum(s["latent_frames"] for s in traced),
            "traced_steps": 0,
            "gaps_ms": gaps,
            "switch_ms": switches,
            "spans": spans,
            "work": dict(work),
            "traced_work": dict(traced_work),
            "attempted": len(segs),
        }

    # -- judgement -------------------------------------------------------------

    def judge(self) -> List[tuple]:
        """The compared numbers: (name, value) pairs, after the program's
        state is freed."""
        self.pipe = self.cache = self.vae_caches = self.hist = None
        self.vparams = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        with RD.no_tf32(), torch.no_grad():
            return self.sampler.judge()


PART_ERRS = (("attn_err", "y"), ("cross_err", "c"), ("ffn_err", "f"))


def judge_layers(W: dict, c: dict, dtype, calls: List[tuple], x_first: torch.Tensor,
                 mod_of, ang: torch.Tensor, context_of, cross_of, errs: Dict[str, list],
                 drift: list):
    """Layer calls of one forward, ``[((layer, kv_only), input, parts)]``
    (``capture.LayerTap``), each part recomputed by the reference from the
    program's input to it (``reference.dit.layer_parts``).  A layer's input
    is ``x_first`` for layer 0 (the reference's embedding), the reference's
    glue over the program's input and parts of the layer before where that
    layer was recorded (so that its gates and sums are judged too), else
    the program's own.  Appends each part's relative error to ``errs`` and
    the distance of each input from the program's to ``drift``; returns
    (the reference's K/V of every layer, the input the layer after the
    last would get, or None after a K/V-only layer)."""
    kvs, prev, out = [], None, None
    for (li, kv_only), x_in, parts in calls:
        mod = mod_of(li)
        if li == 0:
            x = x_first
        elif prev is not None and prev[0] == li - 1:
            x = RD.residual(prev[1].float(), prev[2], prev[3], dtype)
            drift.append(_rel(x_in, x))
        else:
            x = x_in.float()
        r = RD.layer_parts(W["blocks"][li], c, x, mod, ang, context_of(li), cross_of(li),
                           kv_only, given=parts, dtype=dtype)
        kvs.append((r["k"], r["v"]))
        if kv_only:
            prev, out = None, None
            continue
        for name, part in PART_ERRS:
            errs[name].append(_rel(parts[part], r[part]) if part in parts else math.inf)
        prev = (li, x_in, mod, parts)
        out = RD.residual(x_in.float(), mod, parts, dtype)
        del r
    return kvs, out


def _host(t):
    return t.cpu() if isinstance(t, torch.Tensor) else t


class _Samples:
    """What the judgement needs, taken while the program runs: the start
    (segment 0, from the seed alone, in the warm-up; its captures kept on
    the host) and the segment right after the window (after a switch where
    the mix posts them): the program's cache before and after it, the
    prompt's K/V it attends, its layers' inputs and parts and its forwards' flows, the decoder's caches
    before it and its units for one latent frame drawn from the seed."""

    def __init__(self, serve: Serve):
        self.s = serve
        ctx, tr = serve.ctx, serve.ctx.traffic
        rng = np.random.default_rng(WT._mix(ctx.seed, 7))
        self.frame = int(rng.integers(0, tr["segment_frames"]))  # its latent frame decoded
        v = serve.cfg["vae"]
        self.units_per_frame = 5 + (v["num_res_blocks"] + 1) * len(v["dim_mult"]) + len(
            v["dim_mult"]) - 1
        self.data: Dict[str, dict] = {}

    def warm_hook(self, stage, seg, *a):
        if seg["start"] != 0:
            return
        if stage == "generate":
            self.data["start"] = {"start": 0, "gen": self.s.gen.get_state(),
                                  "prompt": self.s.prompt,
                                  "units": UnitCapture(self.units_per_frame, 0)}
        elif stage == "decode":
            self.data["start"]["units"].install()
        elif stage == "shipped":
            d = self.data["start"]
            d["units"].remove()
            lat, px = a
            d.update(lat=lat.cpu(), px=px.cpu(), units=[
                (k, _host(x), [_host(u) for u in used], _host(y), args)
                for k, x, used, y, args in d["units"].units])

    def take(self, stage, seg, *a):
        s = self.s
        d = self.data.setdefault("block", {"start": seg["start"], "cap": LayerCapture(),
                                           "n_recache": 0, "n_recache_fwd": 0})
        if stage == "switch":
            d.update(hist=s.hist.clone())
            d["cap"].install()
        elif stage == "generate":
            d.update(gen=s.gen.get_state(), before=_Snap(s.cache), prompt=s.prompt,
                     cross=s.cross)
            if d["cap"].orig is None:
                d["cap"].install()
            d["n_recache"] = len(d["cap"].calls)
            d["n_recache_fwd"] = len(d["cap"].forwards)
        elif stage == "decode":
            d["cap"].remove()
            d["vae"] = [c.clone() for c in s.vae_caches]
            d["units"] = UnitCapture(self.units_per_frame, self.frame)
            d["units"].install()
        elif stage == "shipped":
            d["units"].remove()
            d["units"] = d["units"].units
            lat, px = a
            d.update(lat=lat.clone(), px=px.clone(), after=_Snap(s.cache))

    # -- the reference's side ----------------------------------------------------

    def judge(self) -> List[tuple]:
        s, c = self.s, self.s.cfg
        dev = s.ctx.device
        hl, wl = latent_hw(c)
        patch = c["patch_size"]
        hp, wp = hl // patch[1], wl // patch[2]
        fs = hp * wp
        fpb = c["num_frame_per_block"]
        nl = c["num_layers"]
        steps = causal_sigmas(c["timestep_shift"], c["denoising_step_list"])
        sink, ring = c["sink_size"], c["local_attn_size"] - c["sink_size"]
        W = s.raw
        crosses = {}
        diag = s.diag = {}
        errs = {n: [] for n in ("attn_err", "cross_err", "ffn_err", "head_err", "kv_err",
                                "vae_err")}
        drift: list = []
        control = s.ctx.variant == "int8"

        def cross(p):
            if p not in crosses:
                crosses[p] = RD.cross_kv(W, c, RD.text_context(W, s.prompts[p].to(dev)))
            return crosses[p]

        def note(key, a, b):  # readings of the outputs end to end, not compared
            diag[key] = _rel(a, b)

        def denoise(start, ctx_kv, gen_state, p):
            g = torch.Generator(device=dev)
            g.set_state(gen_state)
            x = s.noise[:, start:start + fpb].float()
            x0 = x
            for i, sig in enumerate(steps):
                flow, _ = RD.causal_forward(W, c, x, sig * 1000.0, start, ctx_kv, cross(p))
                x0 = x - sig * flow
                if i < len(steps) - 1:
                    eps = torch.randn(x0.shape, generator=g, dtype=torch.float32, device=dev)
                    x = (1.0 - steps[i + 1]) * x0 + steps[i + 1] * eps
            return x0

        def forward(calls, latents, t, start, ctx, ckv):
            """One forward's layers judged, each cross-attention over the
            program's own prompt K/V ``ckv`` (its state, made by the code
            that the t2v cell judges from the prompt); (the reference's K/V
            of every layer, its flow from the last layer's output, or None)."""
            nf = latents.shape[1]
            e, e0 = RD.time_embedding(W, c, torch.full((1,), float(t), device=dev))
            ang = RD.rope_angles(c["dim"] // c["num_heads"], start, nf, hp, wp, dev)
            x_first = RD.linear(RD.patchify(latents.to(s.dtype).float(), patch),
                                W["patch_embedding"]).to(s.dtype).float()
            kvs, out = judge_layers(
                W, c, s.dtype, calls, x_first,
                lambda li: (RD.f32(W["blocks"][li]["modulation"])[None] + e0)[:, None], ang,
                lambda li: None if ctx is None else ctx[li],
                lambda li: (ckv.k[li].float(), ckv.v[li].float()), errs, drift)
            if out is None:
                return kvs, None, None
            flow = RD.unpatchify(RD._head(W, c, out, e[:, None]), patch, c["out_dim"], nf, hl, wl)
            ctl = None
            if control:  # the head's control: the reference's head in float8
                RD.Operands.fp8 = True
                try:
                    ctl = RD.unpatchify(RD._head(W, c, out, e[:, None]), patch, c["out_dim"],
                                        nf, hl, wl)
                finally:
                    RD.Operands.fp8 = False
            return kvs, flow, ctl

        def ckv_vs(prog, ref):
            """Worst layer's error of the program's prompt K/V against the
            reference's per-layer K/V ``ref``."""
            worst = 0.0
            for li, (k, v) in enumerate(ref):
                worst = max(worst, _rel(prog.k[li].reshape(k.shape), k),
                            _rel(prog.v[li].reshape(v.shape), v))
            return worst

        def kv_vs(snap, slots, kvs, nf):
            """Worst layer's error of the program's cached K/V in ``slots``
            against the reference's per-layer K/V of ``nf`` frames."""
            return _kv_err(snap, slots, _split_frames(kvs, nf, fs), fs, diag)

        def vae_units(units, lat, px, first, j):
            """Latent frame j's decoder units, each recomputed from the
            program's own input to it and the caches it consumed; the first
            from the shipped latents, the head's output clamped against the
            frame's shipped pixels: the worst unit's relative error."""
            dec = s.vraw["decoder"]
            seq = [dec["conv1"]] + dec["middle"] + dec["upsamples"] + [None]
            if len(units) != len(seq):
                return math.inf
            lat, px = lat.to(dev), px.to(dev)
            mean = s.vraw["mean"].float().reshape(1, -1, 1, 1, 1)
            std = s.vraw["std"].float().reshape(1, -1, 1, 1, 1)
            r = 2 ** sum(c["vae"]["temperal_downsample"])  # pixel frames a later latent frame makes
            pf = 0 if j == 0 else (1 + r * (j - 1) if first else r * j)
            n_px = 1 if first and j == 0 else r
            worst = 0.0
            for p, (kind, x_in, used, x_out, args) in zip(seq, units):
                cc = RV._Caches([u.to(dev) for u in used])
                if p is dec["conv1"]:  # the latents as the decoder reads them, in the served dtype
                    z = lat[:, j:j + 1].to(s.dtype).float().permute(0, 2, 1, 3, 4) * std + mean
                    y = RV.causal_conv(RV.causal_conv(z, s.vraw["conv2"], None), p, cc)
                else:
                    xin = x_in.to(dev).float().permute(0, 4, 1, 2, 3)
                    if p is None:
                        y = RV.causal_conv(F.silu(RV._norm(xin, dec["head_norm"])),
                                           dec["head_conv"], cc)
                    elif kind == "res_block":
                        y = RV.res_block(xin, p, cc)
                    elif kind == "attention_block":
                        y = RV.attn_block(xin, p)
                    else:
                        y = RV.upsample(xin, p, cc, args[0], args[1])
                if p is None:  # the pixels this latent frame shipped
                    y = torch.clamp(y, -1.0, 1.0).permute(0, 2, 1, 3, 4)
                    if y.shape[1] != n_px:
                        return math.inf
                    worst = max(worst, _rel(px[:, pf:pf + n_px], y))
                else:
                    worst = max(worst, _rel(x_out.to(dev).float(), y.permute(0, 2, 3, 4, 1)))
            return worst

        names = list(errs)
        # the start: block 0 from the seed alone (a reading) and its decode from zero caches
        d0 = self.data["start"]
        lat0, px0 = d0["lat"].to(dev), d0["px"].to(dev)
        note("x0_start", lat0[:, :fpb], denoise(0, None, d0["gen"], d0["prompt"]))
        px_ref, _ = RV.decode(s.vraw, c["vae"], lat0.float(), None, True)
        note("px_start", px0, px_ref)
        errs["vae_err"].append(vae_units(d0["units"], lat0, px0, True, 0))

        d = self.data["block"]
        start, p, ckv = d["start"], d["prompt"], d["cross"]
        # a reading, not compared: the program's prompt K/V against the
        # reference's (bf16 rounds K twice in its RMSNorm, which the int8
        # control shares: the two read 2.4x apart, PERF.md)
        diag["ckv_prompt"] = ckv_vs(ckv, cross(p))
        calls = d["cap"].calls
        fwds = d["cap"].forwards[d["n_recache_fwd"]:]
        nb = s.ctx.traffic["segment_frames"] // fpb  # the segment's blocks; the first is judged
        want = nl * (len(steps) + 1) * nb + d["n_recache"]
        if (len(calls) != want
                or len(d["cap"].forwards) != (len(steps) + 1) * nb + d["n_recache_fwd"]):
            # the program skipped work it owes: no number can be read
            diag["layer_calls"] = [len(calls), want]
            return [(n, math.inf) for n in names]
        if "hist" in d:  # a switch: the program's recache, layer by layer
            n = d["hist"].shape[1]
            kvs, _, _ = forward(calls[:d["n_recache"]], d["hist"], c["context_noise"], start - n,
                                None, ckv)
            errs["kv_err"].append(kv_vs(d["before"], list(range(n)), kvs, n))
            sink_frames, base = list(range(start - n, start - n + sink)), start - n + sink
            calls = calls[d["n_recache"]:]
        else:
            sink_frames, base = list(range(sink)), sink

        def slot(f):
            return f - sink_frames[0] if f in sink_frames else sink + (f - base) % ring

        ctx_frames = sink_frames + list(range(start - (ring - fpb), start))
        ctx = []
        snaps = [d["before"].frame_kv(slot(f), fs) for f in ctx_frames]
        for li in range(nl):
            ctx.append((torch.cat([k[li] for k, _ in snaps], 1),
                        torch.cat([v[li] for _, v in snaps], 1)))
        del snaps
        # the block's four denoise forwards and its commit, layer by layer; the
        # chain between them is the scheduler's arithmetic on the program's
        # flows, and each step's x0 is held against the reference head's (the
        # last step's: the shipped latents)
        g = torch.Generator(device=dev)
        g.set_state(d["gen"])
        x = s.noise[:, start:start + fpb].float()
        for i, sig in enumerate(steps):
            _, flow, ctl = forward(calls[i * nl:(i + 1) * nl], x, sig * 1000.0, start, ctx, ckv)
            x0_ref = x - sig * flow
            x0 = x - sig * fwds[i][1].float()
            if ctl is not None:
                x0_prog = x - sig * ctl
            elif i == len(steps) - 1:
                x0_prog = d["lat"][:, :fpb].float()
            else:
                x0_prog = x0
            errs["head_err"].append(_rel(x0_prog, x0_ref))
            if i < len(steps) - 1:
                eps = torch.randn(x0.shape, generator=g, dtype=torch.float32, device=dev)
                x = (1.0 - steps[i + 1]) * x0 + steps[i + 1] * eps
        com = calls[len(steps) * nl:(len(steps) + 1) * nl]
        kvs, _, _ = forward(com, d["lat"][:, :fpb], c["context_noise"], start, ctx, ckv)
        errs["kv_err"].append(kv_vs(d["after"], [slot(f) for f in range(start, start + fpb)],
                                    kvs, fpb))
        # the whole block from the program's cache, a reading
        note("x0", d["lat"][:, :fpb], denoise(start, ctx, d["gen"], p))
        del ctx
        px_ref, _ = RV.decode(s.vraw, c["vae"], d["lat"].float(), d["vae"], False)
        note("px", d["px"], px_ref)
        errs["vae_err"].append(vae_units(d["units"], d["lat"], d["px"], False, self.frame))
        diag["drift"] = max(drift, default=0.0)
        diag["worst3"] = {n: sorted(v)[-3:] for n, v in errs.items()}
        return [(n, max(errs[n])) for n in names]


def _kv_err(snap: _Snap, slots: List[int], ref: List[List], fs: int, diag=None) -> float:
    """The worst layer's relative RMS error of the program's cached K and V
    in ``slots`` against the reference's frames ``ref`` (per frame, per layer)."""
    worst = 0.0
    per = []
    nl = len(ref[0])
    ks, vs = zip(*(snap.frame_kv(sl, fs) for sl in slots))
    for li in range(nl):
        kp = torch.cat([k[li] for k in ks], 1)
        vp = torch.cat([v[li] for v in vs], 1)
        kr = torch.cat([r[li][0] for r in ref], 1)
        vr = torch.cat([r[li][1] for r in ref], 1)
        worst = max(worst, _rel(kp, kr), _rel(vp, vr))
        per.append((_rel(kp, kr), _rel(vp, vr)))
    if diag is not None:
        diag.setdefault("kv_layers", []).append(per)
    return worst
