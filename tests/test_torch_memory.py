"""Host memory and layer streaming (``longlive_torch.utils.memory``), the
host-resident load, and the host-streamed bidirectional forward, on the
CPU: ``stream_scan`` against the plain loop bit for bit, the offload and
fetch round trips, ``blocks_to_host``, ``load_base_dit(on_host=True)``
against the resident load, and ``bidirectional_forward_streamed`` in both
forms against the JAX package's (within 1e-4 of max |ref|, float32) and
against the port's resident forward (bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import tiny_dit_config, tiny_geometry
from longlive_torch.models import dit as TD
from longlive_torch.models import dit_bidirectional as TB
from longlive_torch.ops.rope import make_rope_tables
from longlive_torch.utils import checkpoint as TC
from longlive_torch.utils import loading
from longlive_torch.utils import memory as M
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models import dit_bidirectional as JB
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.utils.memory import blocks_to_host as j_blocks_to_host

TOL = 1e-4  # of max |ref|: float32, summation orders differ


def _tree(g):
    return {"a": torch.randn((3, 5), generator=g),
            "b": [torch.randn((7,), generator=g).to(torch.bfloat16),
                  (torch.randint(-128, 127, (2, 3), generator=g, dtype=torch.int8),
                   torch.randn((), generator=g))],
            "c": {"d": torch.zeros((0, 4)), "e": None}}


def _equal(a, b):
    la, lb = M.param_leaves(a), M.param_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def test_offload_and_fetch_round_trip_bit_equal():
    tree = _tree(torch.Generator().manual_seed(0))
    host = M.offload_to_host(tree)
    assert _equal(host, tree)
    assert all(h.data_ptr() != t.data_ptr() or t.numel() == 0
               for h, t in zip(M.param_leaves(host), M.param_leaves(tree)))
    back = M.fetch_from_host(host, "cpu")
    assert _equal(back, tree)
    assert isinstance(back["b"][1], tuple) and back["c"]["e"] is None
    assert M.hbm_bytes(tree) == 15 * 4 + 7 * 2 + 6 + 4


def test_host_arena_carves_tensors_of_every_dtype():
    arena = M.HostArena()
    for shape, dt in (((3, 4), torch.float32), ((5,), torch.bfloat16), ((), torch.float32),
                      ((0, 2), torch.float32), ((9,), torch.int8)):
        t = arena.empty(shape, dt)
        assert tuple(t.shape) == shape and t.dtype == dt and t.device.type == "cpu"


def test_stream_scan_equals_the_plain_loop():
    """Per-layer dicts and (layer, cross K, cross V) tuples: the same
    carries as the loop over the layers, bit for bit."""
    g = torch.Generator().manual_seed(1)
    layers = [{"w": torch.randn((6, 6), generator=g), "b": torch.randn((6,), generator=g)}
              for _ in range(4)]
    extra = torch.randn((4, 6), generator=g)

    def step(x, layer):
        return torch.tanh(x @ layer["w"] + layer["b"])

    x0 = torch.randn((2, 6), generator=g)
    want = x0
    for layer in layers:
        want = step(want, layer)
    host = [M.offload_to_host(layer) for layer in layers]
    assert torch.equal(M.stream_scan(step, x0, host, "cpu"), want)
    want2 = x0
    for layer, e in zip(layers, extra):
        want2 = step(want2, layer) * e
    got2 = M.stream_scan(lambda x, xs: step(x, xs[0]) * xs[1], x0, list(zip(host, extra)), "cpu")
    assert torch.equal(got2, want2)
    assert M.stream_scan(step, x0, [], "cpu") is x0


@pytest.fixture(scope="module")
def bidi():
    jcfg = j_tiny()
    tree = jax.tree.map(np.asarray, JD.init_dit_params(jax.random.PRNGKey(3), jcfg, jnp.float32,
                                                       zero_head=False))
    geom = tiny_geometry()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2, geom.channels, geom.height, geom.width)).astype(np.float32)
    t = np.asarray([700.0, 250.0], np.float32)
    pe = rng.standard_normal((2, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    return jcfg, tiny_dit_config(), tree, x, t, pe


def test_blocks_to_host_keeps_the_small_parts_on_the_device(bidi):
    _, tcfg, tree, _, _, _ = bidi
    params = dit_params_from_jax(tree)
    out = M.blocks_to_host(params, "cpu")
    assert out.keys() == params.keys() and len(out["blocks"]) == tcfg.num_layers
    assert _equal(out, params)
    assert out["head"]["head"]["weight"] is params["head"]["head"]["weight"]
    assert out["blocks"][0]["ffn"]["fc1"]["weight"] is not params["blocks"][0]["ffn"]["fc1"][
        "weight"]


@pytest.mark.parametrize("form", ["cross_kv", "context"])
def test_streamed_bidirectional_forward_matches_jax_and_the_resident_forward(bidi, form):
    """Both forms against the JAX package's streamed forward (dense
    attention) and, bit for bit, against the port's resident forward on
    the same tree, under both attention routes (their plain versions)."""
    jcfg, tcfg, tree, x, t, pe = bidi
    jp = jax.tree.map(jnp.asarray, tree)
    jt = j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos)
    jhost = j_blocks_to_host(jp)
    if form == "cross_kv":
        jcross = JD.prepare_cross_kv(jp, jcfg, jnp.asarray(pe), jnp.float32)
        want = JB.bidirectional_forward_streamed(jhost, jcfg, jt, jnp.asarray(x), jnp.asarray(t),
                                                 cross_kv=jcross, attn_impl="xla")
    else:
        want = JB.bidirectional_forward_streamed(jhost, jcfg, jt, jnp.asarray(x), jnp.asarray(t),
                                                 attn_impl="xla", context=jnp.asarray(pe))
    want = np.asarray(want)
    params = dit_params_from_jax(tree)
    tt = make_rope_tables(tcfg.head_dim, tcfg.rope_max_pos)
    host = M.blocks_to_host(params, "cpu")
    xt, tt_, pt = (torch.from_numpy(a) for a in (x, t, pe))
    cross = TD.prepare_cross_kv(params, tcfg, pt, torch.float32)
    for impl in TB.ATTN_IMPLS:
        with torch.no_grad():
            resident = TB.bidirectional_forward(params, tcfg, tt, xt, tt_, cross, attn_impl=impl)
            kw = dict(cross_kv=cross) if form == "cross_kv" else dict(context=pt)
            got = TB.bidirectional_forward_streamed(host, tcfg, tt, xt, tt_, attn_impl=impl, **kw)
        assert torch.equal(got, resident), impl
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, (impl, err)
    with pytest.raises(ValueError):
        TB.bidirectional_forward_streamed(host, tcfg, tt, xt, tt_)


def test_load_base_dit_on_host_equals_the_resident_load(tmp_path, monkeypatch):
    """The random init (seeded) and a checkpoint file: the host-resident
    tree holds the same values as the resident one, every tensor on the
    host; ``place_block`` changes no draw."""
    cfg = tiny_dit_config()
    monkeypatch.chdir(tmp_path)
    want = loading.load_base_dit("wan_models/none", cfg, torch.float32, "cpu", seed=4)
    got = loading.load_base_dit("wan_models/none", cfg, torch.float32, "cpu", seed=4,
                                on_host=True)
    assert _equal(got, want)
    assert all(t.device.type == "cpu" for t in M.param_leaves(got))
    placed = []
    tree = TD.init_dit_params(cfg, torch.float32, "cpu", seed=4,
                              place_block=lambda b: placed.append(1) or b)
    assert _equal(tree, want) and len(placed) == cfg.num_layers
    path = tmp_path / "dit.pth"
    torch.save(TC.dit_state_dict(want, cfg), path)
    from_file = loading.load_base_dit(str(path), cfg, torch.float32, "cpu", on_host=True)
    assert _equal(from_file, want)


def test_log_memory_returns_its_line(capsys):
    line = M.log_memory("here")
    assert line.startswith("[mem] here:") and line in capsys.readouterr().out
