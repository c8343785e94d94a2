"""Interactive generation with streaming prompt switches (KV-recache).

Every prompt segment is encoded up front; when generation reaches a switch
index, the KV cache is rebuilt by replaying the last ``min(local_attn_size,
t)`` generated frames under the new prompt, and generation continues from
the rebuilt cache.

``global_sink=False`` (the shipped interactive config) zeroes the cache and
lets the replay overwrite the sink slots: the sink becomes the first frames
of the replay window.  ``global_sink=True`` keeps the original sink K/V (the
first frames of the video) and replays only the window.

Three loops: ``generate_latents_interactive`` (one-shot recache at each
switch, with the ``[profile]`` line that prints the switch stall),
``generate_latents_interactive_scanned`` (the production path: the eager
recache commits the replay window while it is generated) and
``generate_latents_reactive`` (switches that arrive unscheduled, polled
before each block).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..models import dit as D
from .causal_inference import CausalInferencePipeline


class InteractiveCausalInferencePipeline(CausalInferencePipeline):
    @torch.no_grad()
    def generate_latents_interactive(
        self, noise: torch.Tensor, cross_kv_list: Sequence[D.CrossKV],
        switch_frame_indices: Sequence[int], generator: Optional[torch.Generator] = None,
        profile: bool = False,
        block_callback: Optional[Callable[[int, torch.Tensor], None]] = None,
    ) -> torch.Tensor:
        """noise [B, T, C, H, W], one CrossKV per prompt segment and
        ``len(cross_kv_list) - 1`` switch frames -> latents [B, T, C, H, W].
        A switch takes effect at the first block starting at or after its
        index, after a one-shot recache."""
        assert len(cross_kv_list) >= 1
        assert len(switch_frame_indices) == len(cross_kv_list) - 1
        b, t_frames = noise.shape[:2]
        fpb = self.frame_block
        assert t_frames % fpb == 0
        generator = self._generator(generator)
        noise = noise.to(self.device)
        global_sink = bool(self.config.global_sink)
        local = self.cfg.local_attn_size

        cache = self.init_cache(b)
        outputs: List[torch.Tensor] = []
        seg = 0
        next_switch = switch_frame_indices[0] if switch_frame_indices else None
        block_times, switch_times = [], []
        for s in range(0, t_frames, fpb):
            t0 = time.perf_counter()
            switched = False
            if next_switch is not None and s >= next_switch:
                seg += 1
                next_switch = (switch_frame_indices[seg]
                               if seg < len(switch_frame_indices) else None)
                n = s if local == -1 else min(local, s)
                if n > 0:
                    replay = torch.cat(outputs, dim=1)[:, s - n:s]
                    cache = self._recache_fn(n, global_sink)(
                        self.params, cache, cross_kv_list[seg], replay, s - n)
                switched = True
            x0, cache = self._block_step(cache, cross_kv_list[seg], noise[:, s:s + fpb], s,
                                         generator)
            if block_callback is not None:
                block_callback(s, x0)
            outputs.append(x0)
            if profile:
                self._sync()
                (switch_times if switched else block_times).append(time.perf_counter() - t0)
        if profile and block_times:
            self._report_profile(block_times, switch_times, fpb)
        return torch.cat(outputs, dim=1)

    @torch.no_grad()
    def generate_latents_interactive_scanned(
        self, noise: torch.Tensor, cross_kv_list: Sequence[D.CrossKV],
        switch_frame_indices: Sequence[int], generator: Optional[torch.Generator] = None,
        profile: bool = False,
    ) -> torch.Tensor:
        """The semantics of generate_latents_interactive, the production
        path.  With ``config.eager_recache`` (and no global sink) the replay
        window of each scheduled switch is committed chunk by chunk as its
        blocks are generated, and the last block before the switch skips its
        commit, so the switch itself only resets counters.  When the next
        switch's window reaches back before this segment's start (switches
        closer than the window), its chunks for those earlier frames run at
        this switch, serially.  Odd-sized replays fall back to the one-shot
        recache.

        ``profile``: prints the ``[profile]`` line with the blocks that open
        a segment as the switch blocks; blocks that also fed an eager chunk
        are reported apart."""
        assert len(switch_frame_indices) == len(cross_kv_list) - 1
        b, t_frames = noise.shape[:2]
        fpb = self.frame_block
        generator = self._generator(generator)
        noise = noise.to(self.device)
        global_sink = bool(self.config.global_sink)
        local = self.cfg.local_attn_size

        # a switch takes effect at the first block start at or after its
        # index, clamped to the video's end
        bounds = [0] + [min(-(-si // fpb) * fpb, t_frames) for si in switch_frame_indices]
        bounds.append(t_frames)

        cache = self.init_cache(b)
        outputs: List[torch.Tensor] = []
        use_eager = bool(self.config.eager_recache) and not global_sink
        er = None  # pending EagerRecache for the upcoming switch
        times = {"block": [], "switch": [], "eager": []}
        t0 = time.perf_counter()

        def tick(kind):
            nonlocal t0
            if profile:
                self._sync()
                now = time.perf_counter()
                times[kind].append(now - t0)
                t0 = now

        for seg in range(len(cross_kv_list)):
            s, e = bounds[seg], bounds[seg + 1]
            if e <= s:
                er = None
                continue  # switch index at or after the video's end
            opening = seg > 0 and s > 0
            if opening:
                n = s if local == -1 else min(local, s)
                if er is not None and er.n == n and er.fed == n:
                    cache = er.finish()
                elif n > 0:
                    replay = torch.cat(outputs, dim=1)[:, s - n:s]
                    cache = self._recache_fn(n, global_sink)(
                        self.params, cache, cross_kv_list[seg], replay, s - n)
            er = None
            sw_next = bounds[seg + 1] if seg + 1 < len(cross_kv_list) else None
            n_next = 0
            if use_eager and sw_next is not None and sw_next > s:
                n_next = sw_next if local == -1 else min(local, sw_next)
                if n_next <= 0 or n_next % fpb:
                    n_next = 0  # odd replay size: one-shot fallback
            w0 = e  # first frame of the next switch's eager replay window
            if n_next:
                er = self.begin_eager_recache(b, sw_next)
                cross_next = cross_kv_list[seg + 1]
                w0 = sw_next - n_next
                if outputs and w0 < s:  # the window reaches into earlier segments
                    er.feed(cross_next, torch.cat(outputs, dim=1)[:, w0:s], w0)
            for bs in range(s, e, fpb):
                # the last block before an eagerly recached switch skips its
                # commit: the eager chunk under the new prompt takes its place
                fed = er is not None and bs >= w0
                x0, cache = self._block_step(cache, cross_kv_list[seg], noise[:, bs:bs + fpb],
                                             bs, generator,
                                             skip_commit=fed and bs + fpb >= e)
                outputs.append(x0)
                if fed:
                    er.feed(cross_next, x0, bs)
                tick("switch" if opening and bs == s else "eager" if fed else "block")
        if profile and times["block"]:
            self._report_profile(times["block"], times["switch"], fpb, times["eager"])
        return torch.cat(outputs, dim=1)

    @torch.no_grad()
    def generate_latents_reactive(
        self, noise: torch.Tensor, cross_kv: D.CrossKV,
        poll_switch: Callable[[int], Optional[D.CrossKV]],
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Serving loop for UNSCHEDULED prompt switches: before each block,
        ``poll_switch(block_start_frame)`` is consulted; a CrossKV it returns
        takes effect at once through ``reactive_switch`` (a replay of
        ``config.reactive_recache_frames`` frames when set, the full window
        otherwise)."""
        b, t_frames = noise.shape[:2]
        fpb = self.frame_block
        assert t_frames % fpb == 0
        generator = self._generator(generator)
        noise = noise.to(self.device)
        cache = self.init_cache(b)
        local = self.cfg.local_attn_size
        outputs: List[torch.Tensor] = []
        cross = cross_kv
        for s in range(0, t_frames, fpb):
            new_cross = poll_switch(s)
            if new_cross is not None and s > 0:
                # only the blocks covering the replay window
                need = s if local == -1 else min(
                    local if self.config.reactive_recache_frames is None
                    else max(self.config.reactive_recache_frames, fpb), s)
                nblk = -(-need // fpb)
                history = torch.cat(outputs[-nblk:], dim=1)
                cache = self.reactive_switch(cache, history, new_cross, s)
                cross = new_cross
            elif new_cross is not None:
                cross = new_cross  # switch before anything was generated
            x0, cache = self._block_step(cache, cross, noise[:, s:s + fpb], s, generator)
            outputs.append(x0)
        return torch.cat(outputs, dim=1)

    def _report_profile(self, block_times, switch_times, fpb, eager_times=()):
        steady = block_times[2:] or block_times
        mean = float(np.mean(steady))
        sw = float(np.mean(switch_times)) if switch_times else 0.0
        line = (f"[profile] steady-state latency={mean / fpb * 1e3:.2f} ms/latent-frame; "
                f"switch blocks avg={sw * 1e3:.2f} ms "
                f"(+{(sw - mean) * 1e3 if switch_times else 0:.2f} ms recache overhead)")
        if eager_times:
            ea = float(np.mean(eager_times))
            line += (f"; eager-chunk blocks avg={ea * 1e3:.2f} ms "
                     f"(+{(ea - mean) * 1e3:.2f} ms)")
        print(line)
        self.last_block_times = block_times
        self.last_switch_times = switch_times
        self.last_eager_times = list(eager_times)
