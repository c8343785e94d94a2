"""The plain reference against the program at a tiny size on the CPU, in
float32: the causal cached forward, the recache, the VAE decoder, the
bidirectional forward and UniPC's coefficients."""

import numpy as np
import pytest
import torch

from benchmark import weights as WT
from benchmark.reference import dit as RD
from benchmark.reference import vae as RV
from benchmark.reference.schedule import unipc_table
from benchmark.serve import _to_interleaved, dit_config
from benchmark.tests.tiny import CAUSAL, T2V


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def causal():
    torch.manual_seed(0)
    raw = WT.make_weights(WT.dit_specs(CAUSAL), 123, 1, torch.float32, "cpu")
    return raw, WT.program_dit(raw, dit_config(CAUSAL))


def test_causal_forward_and_commit_match_the_program(causal):
    from longlive_torch.config import CacheConfig, LatentGeometry
    from longlive_torch.models import dit as D
    from longlive_torch.ops import kv_cache as kvc
    from longlive_torch.ops.rope import make_rope_tables

    raw, prog = causal
    cfg = dit_config(CAUSAL)
    geom = LatentGeometry(channels=4, height=8, width=8)
    cc = CacheConfig.from_model(cfg, geom, 60)
    tables = make_rope_tables(cfg.head_dim, 1024)
    emb = WT.prompt_embeds(CAUSAL, 5, 10, torch.float32, "cpu")
    cross = D.prepare_cross_kv(prog, cfg, emb, torch.float32)
    rcross = RD.cross_kv(raw, CAUSAL, RD.text_context(raw, emb))
    cache = kvc.init_cache(cc, cfg.num_layers, 1, cfg.num_heads, cfg.head_dim, torch.float32)
    x = torch.randn(1, 3, 4, 8, 8)
    # block 0: three frames over an empty cache, then its commit
    t = torch.full((1, 3), 937.5)
    flow, cache = D.dit_forward_cached(prog, cfg, cc, tables, x, t, cross, cache, 0,
                                       advance_counters=False)
    rflow, _ = RD.causal_forward(raw, CAUSAL, x, 937.5, 0, None, rcross)
    assert _rel(flow, rflow) < 1e-5
    _, cache = D.dit_forward_cached(prog, cfg, cc, tables, x, torch.zeros(1, 3), cross, cache,
                                    0, kv_only=True)
    _, kvs = RD.causal_forward(raw, CAUSAL, x, 0.0, 0, None, rcross, kv_only=True)
    for li, (k, v) in enumerate(kvs):
        pk = _to_interleaved(cache.k[li, :, :, :48]).transpose(1, 2)
        assert _rel(pk, k) < 1e-5
        assert _rel(cache.v[li, :, :, :48].transpose(1, 2), v) < 1e-5
    # block 1 attends block 0's committed K/V
    x1 = torch.randn(1, 3, 4, 8, 8)
    flow1, _ = D.dit_forward_cached(prog, cfg, cc, tables, x1, t, cross, cache, 3)
    rflow1, _ = RD.causal_forward(raw, CAUSAL, x1, 937.5, 3, kvs, rcross)
    assert _rel(flow1, rflow1) < 1e-5


def test_vae_decode_matches_the_program():
    from longlive_torch.models import vae as V
    from benchmark.serve import _vae_config

    vcfg = CAUSAL["vae"]
    raw = WT.make_vae(vcfg, 7, torch.float32, "cpu")
    lat = torch.randn(1, 4, 4, 8, 8)
    px, caches = V.vae_decode_scan(WT.program_vae(raw), _vae_config(vcfg), lat[:, :2])
    rpx, rcaches = RV.decode(raw, vcfg, lat[:, :2], None, True)
    assert _rel(px, rpx) < 1e-5
    # continuing from the program's caches, as the judgement does
    px2, _ = V.vae_decode_scan(WT.program_vae(raw), _vae_config(vcfg), lat[:, 2:], caches, False)
    rpx2, _ = RV.decode(raw, vcfg, lat[:, 2:], caches, False)
    assert _rel(px2, rpx2) < 1e-5
    assert len(rcaches) == len(caches)


def test_bidirectional_forward_matches_the_program():
    from longlive_torch.models import dit as D
    from longlive_torch.models.dit_bidirectional import bidirectional_forward
    from longlive_torch.ops.rope import make_rope_tables

    raw = WT.make_weights(WT.dit_specs(T2V), 9, 1, torch.float32, "cpu")
    cfg = dit_config(T2V)
    prog = WT.program_dit(raw, cfg)
    emb = WT.prompt_embeds(T2V, 9, 10, torch.float32, "cpu")
    x = torch.randn(2, 3, 4, 8, 8)
    t = torch.tensor([999.0, 500.0])
    cross = D.prepare_cross_kv(prog, cfg, torch.cat([emb, emb]), torch.float32)
    out = bidirectional_forward(prog, cfg, make_rope_tables(cfg.head_dim, 1024), x, t, cross)
    ref = RD.bidirectional_forward(raw, T2V, x, t, RD.cross_kv(raw, T2V, RD.text_context(
        raw, torch.cat([emb, emb]))))
    assert _rel(out, ref) < 1e-5


def test_unipc_table_matches_the_program():
    from longlive_torch.ops import solvers as SV

    t = unipc_table(50, 5.0)
    c = SV.unipc_coefficients(50, 5.0)
    for mine, theirs in (("ax", "ax"), ("am0", "am0"), ("am1", "am1"), ("bxt", "bxt"),
                         ("bx", "bx"), ("bmt", "bmt"), ("bm1", "bm1"), ("bm2", "bm2"),
                         ("sigma", "sigmas"), ("timestep", "timesteps")):
        np.testing.assert_allclose(t[mine], getattr(c, theirs), rtol=1e-6, atol=1e-7)
    assert not np.any(c.am2)
