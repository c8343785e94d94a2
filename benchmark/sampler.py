"""Wan2.1's text-to-video sampler: guided UniPC steps of one 50-step clip
after another, each clip from new seeded noise, through
``longlive_torch.pipeline.Text2VideoPipeline``'s guided model and
``longlive_torch.ops.solvers.sample_flow``.

A step is the cond + uncond forward in one batch of 2 and the solver's
update.  The window keeps one step in flight: before it enqueues step k it
waits for the end of step k - 2, and it closes at the first step boundary
past ``--seconds``; the steps enqueued by then are all completed and all
counted.

Judgement: the reference replays UniPC in float64 from the clip's noise
with the program's own guided outputs, up to a step drawn from the seed,
and judges that step's chosen layers part by part (self-attention,
cross-attention, FFN), each from the program's input to it, and the head's
guided output from the last layer.  A wrong solver puts the program's x,
and so its first layer, elsewhere.
"""

from __future__ import annotations

import math
import time
from typing import List

import numpy as np
import torch

from . import weights as WT
from .flops import model as FL
from .harness import Ctx, cuda_events, sync
from .reference import dit as RD
from .reference.schedule import UniPC, unipc_table
from .capture import LayerTap
from .serve import _rel, dit_config, judge_layers


class _Closed(Exception):
    """The window's deadline passed at a step boundary."""


class Sampler:
    def __init__(self, ctx: Ctx):
        from longlive_torch.ops import quant
        from longlive_torch.pipeline import Text2VideoPipeline

        self.ctx = ctx
        c, tr = ctx.config, ctx.traffic
        self.cfg = c
        dev = ctx.device
        self.dtype = getattr(torch, c["dtype"])
        with ctx.phase("weights"):
            self.raw = WT.make_weights(WT.dit_specs(c), ctx.seed, 1, self.dtype, dev)
            params = WT.program_dit(self.raw, dit_config(c))
            if ctx.variant == "int8":
                params = quant.quantize_dit_params(params)
            self.cond = WT.prompt_embeds(c, ctx.seed, 10, self.dtype, dev)
            self.null = torch.zeros_like(self.cond)
        with ctx.phase("kernels"):
            ctx.load_kernels(["flash_attention"] + (["int8_linear"] if ctx.variant == "int8"
                                                     else []))
        with ctx.phase("pipeline"):
            self.pipe = Text2VideoPipeline(params, dit_config(c), device=dev)
            self.model_fn, self.coeffs = self.pipe.prepare_sampler(
                self.cond, self.null, sampling_steps=c["sample_steps"], shift=c["sample_shift"],
                guide_scale=c["sample_guide_scale"], solver=c["sample_solver"])
            if ctx.variant == "fp8ref":
                # the control: the reference in the program's place, its matmul
                # operands in float8 (the sampler has no int8 or fp8 path of its own)
                self.model_fn = self._reference_model(fp8=True)
        hl, wl = c["height"] // c["vae_stride"][1], c["width"] // c["vae_stride"][2]
        frames = (c["frame_num"] - 1) // c["vae_stride"][0] + 1
        self.shape = (tr["batch"], frames, c["in_dim"], hl, wl)
        self.frames = frames
        self.noise_gen = WT.generator(ctx.seed, 3, dev)
        rng = np.random.default_rng(WT._mix(ctx.seed, 7))
        nl = c["num_layers"]
        # the layers judged: the first and the last (the links to the solver
        # and the head) and three drawn from the seed
        self.layers = sorted({0, nl - 1} | set(rng.choice(np.arange(1, max(nl - 1, 2)),
                                                          size=min(3, max(nl - 2, 1)),
                                                          replace=False).tolist()))
        # past step 0, so that the solver is judged too
        self.pick = int(rng.integers(1, min(tr["judge_steps"], c["sample_steps"])))
        self.steps = 0
        self.sample = None

    def _sampled_call(self, x, t):
        """The drawn step's model call, its layers recorded."""
        self.ctx.read_memory_peak()  # the program's, before the judgement's copies
        if self.ctx.variant == "fp8ref":
            self.sample["layers"] = {li: {} for li in self.layers}
            return self.model_fn(x, t, record=self.sample["layers"])
        from longlive_torch.models import dit_bidirectional as DB

        nl = self.cfg["num_layers"]
        layers = set(self.layers)
        cap = LayerTap(DB, "_bidi_block",
                       lambda a, kw, i: (a[0], a[1], i % nl if i % nl in layers else None))
        cap.install()
        try:
            v = self.model_fn(x, t)
        finally:
            cap.remove()
        self.sample["layers"] = {li: {"x_in": x_in, **parts} for li, x_in, parts in cap.calls}
        return v

    def _reference_model(self, fp8: bool):
        """The guided model of the plain reference, ``fp8``: its matmul
        operands rounded to float8 e4m3."""
        c, W, dev = self.cfg, self.raw, self.ctx.device
        with RD.no_tf32(), torch.no_grad():
            cross = [RD.cross_kv(W, c, RD.text_context(W, e.to(dev))) for e in (self.cond, self.null)]
        both = [(torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])) for a, b in zip(*cross)]

        def model_fn(x, t, record=None):
            RD.Operands.fp8 = fp8
            try:
                with RD.no_tf32(), torch.no_grad():
                    xx = torch.cat([x, x]).float()
                    out = RD.bidirectional_forward(W, c, xx, torch.full((2,), t, device=dev), both,
                                                   record=record)
            finally:
                RD.Operands.fp8 = False
            b = x.shape[0]
            return out[b:] + c["sample_guide_scale"] * (out[:b] - out[b:])

        return model_fn

    def _noise(self) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.noise_gen, device=self.ctx.device)

    def run(self) -> dict:
        from longlive_torch.ops import attention as A
        from longlive_torch.ops import solvers as SV

        ctx, tr, c = self.ctx, self.ctx.traffic, self.cfg
        with ctx.phase("warmup"):
            x = self._noise().to(self.dtype)
            for _ in range(tr["warmup_steps"]):
                self.model_fn(x, float(self.coeffs.timesteps[0]))
            sync(ctx.device)
        ctx.setup_done()
        A.reset_launches()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        marks: List = []
        clip = {"i": 0}
        stop = {"at": None}

        def model_fn(x, t):
            # one step in flight: wait for the end of step k - 2 before step k
            k = self.steps
            if k > 0:
                ev = cuda_events(ctx.device, 1)[0]
                ev.record()
                marks.append(ev)
            if k > 1 and ctx.device.type == "cuda":
                marks[k - 2].synchronize()
            if stop["at"] is None:
                done = time.perf_counter() >= deadline and len(self.sample["v"]) > self.pick
            else:
                done = k >= stop["at"]
            if done:
                raise _Closed
            if clip["i"] == 0 and k == self.pick and stop["at"] is None:
                v = self._sampled_call(x, t)
            else:
                v = self.model_fn(x, t)
            if clip["i"] == 0:
                self.sample["v"].append(v.detach().float().clone())
            self.steps += 1
            return v

        try:
            while True:
                noise = self._noise()
                if clip["i"] == 0:
                    self.sample = {"noise": noise.clone(), "v": []}
                SV.sample_flow(model_fn, noise.to(self.dtype), self.coeffs)
                clip["i"] += 1
        except _Closed:
            pass
        sync(ctx.device)
        t_end = time.perf_counter()
        counters = {"k1_launches": dict(A.mode_launches)}
        steps = self.steps
        n_traced = 0
        if ctx.trace:
            # after the window: steps of a new clip under the profiler
            clip["i"] += 1
            stop["at"] = steps + tr["trace_steps"]
            ctx.tracer.start()
            try:
                SV.sample_flow(model_fn, self._noise().to(self.dtype), self.coeffs)
            except _Closed:
                pass
            ctx.tracer.stop()
            n_traced = self.steps - steps
            if ctx.device.type == "cuda":  # one more step with the host's operations
                stop["at"] = self.steps + 1
                ctx.tracer.start(host=True)
                try:
                    SV.sample_flow(model_fn, self._noise().to(self.dtype), self.coeffs)
                except _Closed:
                    pass
                ctx.tracer.stop()
        step_work = FL.bidirectional_step(c, self.frames, 2 * tr["batch"])
        work, traced_work = FL.Work(), FL.Work()
        for _ in range(steps):
            work.update(step_work)
        for _ in range(n_traced):
            traced_work.update(step_work)
        return {
            "window_s": t_end - t0, "steps": steps, "traced_steps": n_traced,
            "work": dict(work), "traced_work": dict(traced_work), "attempted": steps,
            "spans": {}, "counters": counters,
        }

    def judge(self) -> List[tuple]:
        """The drawn step of the window's first clip: its judged layers part
        by part, each part recomputed from the program's input to it (the
        first layer's from the reference's UniPC replay of the program's
        flows, in the served dtype; ``judge_layers``): ``attn_err``,
        ``cross_err``, ``ffn_err``, the worst layer's; ``head_err``, the
        guided flow from the last layer's output."""
        names = ["attn_err", "cross_err", "ffn_err", "head_err"]
        c, s = self.cfg, self.sample
        self.pipe = self.model_fn = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        k, W, dev = self.pick, self.raw, self.ctx.device
        recs = s.get("layers", {})
        if sorted(recs) != self.layers or any(set(r) != {"x_in", "y", "c", "f"}
                                              for r in recs.values()):
            return [(n, math.inf) for n in names]
        patch = c["patch_size"]
        with RD.no_tf32(), torch.no_grad():
            uni = UniPC(s["noise"].to(self.dtype).float(), unipc_table(c["sample_steps"],
                                                                       c["sample_shift"]))
            for i in range(k):
                uni.step(s["v"][i])
            x = uni.x.to(self.dtype).float()
            b = x.shape[0]
            xx = torch.cat([x, x])
            if any(r["x_in"].shape[0] != 2 * b for r in recs.values()):
                return [(n, math.inf) for n in names]  # a batch row missing
            hp, wp = x.shape[-2] // patch[1], x.shape[-1] // patch[2]
            cross = [RD.cross_kv(W, c, RD.text_context(W, e.to(dev)))
                     for e in (self.cond, self.null)]
            both = [(torch.cat([a[0], q[0]]), torch.cat([a[1], q[1]])) for a, q in zip(*cross)]
            e, e0 = RD.time_embedding(W, c, torch.full((2 * b,), uni.timestep, device=dev))
            ang = RD.rope_angles(c["dim"] // c["num_heads"], 0, x.shape[1], hp, wp, dev)
            x_first = RD.linear(RD.patchify(xx, patch), W["patch_embedding"]).to(
                self.dtype).float()
            errs = {n: [] for n in names}
            drift: list = []
            calls = [((li, False), r["x_in"], {p: r[p] for p in ("y", "c", "f")})
                     for li, r in sorted(recs.items())]
            _, out = judge_layers(
                W, c, self.dtype, calls, x_first,
                lambda li: (RD.f32(W["blocks"][li]["modulation"])[None] + e0)[:, None], ang,
                lambda li: None, lambda li: both[li], errs, drift)
            y = RD._head(W, c, out, e[:, None])
            full = RD.unpatchify(y, patch, c["out_dim"], x.shape[1], x.shape[-2], x.shape[-1])
            v_head = full[b:] + c["sample_guide_scale"] * (full[:b] - full[b:])
            errs["head_err"].append(_rel(s["v"][k], v_head))
            del full, y, out
            # a reading: the whole guided forward at the replayed x
            full = RD.bidirectional_forward(W, c, xx, torch.full((2 * b,), uni.timestep,
                                                                 device=dev), both)
            v_ref = full[b:] + c["sample_guide_scale"] * (full[:b] - full[b:])
        self.diag = {"flow": _rel(s["v"][k], v_ref), "step": k, "layers": self.layers,
                     "drift": max(drift, default=0.0), "parts": errs}
        return [(n, max(errs[n])) for n in names]
