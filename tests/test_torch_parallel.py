"""The port's mesh rules and Ulysses sequence parallelism
(``longlive_torch.parallel``) held against the JAX package's
(``longlive_tpu.parallel``) on the CPU.

- The FSDP rule table against JAX's ``param_pspec`` on the tiny and the
  Wan2.1-1.3B DiT shapes and the tiny umT5's, at fsdp 2, 4 and 8 (no
  ranks: shapes only; JAX's kernel [.., d_in, d_out] is the port's weight
  [d_out, d_in]).
- On 4 gloo ranks, spawned once for the module: ``ulysses_attention`` at
  P 2 (two groups of 2) and 4 against JAX's inside ``shard_map`` on the
  8-device CPU mesh; ``sp_bidirectional_forward`` against JAX's at sp 2
  and 4; the shard / gather round trip of the tiny DiT.  The tolerance is
  the port's bidirectional parity test's (``tests/test_torch_t2v.py``,
  1e-4: float32, sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from longlive_torch.parallel import mesh as TM
from longlive_tpu.config import DiTConfig as JDiTConfig
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models import t5 as JT5
from longlive_tpu.ops.rope import make_rope_tables as j_rope_tables
from longlive_tpu.parallel import mesh as JM
from longlive_tpu.parallel import sequence as JS

from torch_dist import random_tree, start_ranks

TOL = 1e-4  # tests/test_torch_t2v.py's bidirectional parity


class _FakeMesh:
    def __init__(self, fsdp):
        self.shape = {"fsdp": fsdp, "dp": 1, "sp": 1}


def _port_leaf(path, shape):
    """The port's path and shape of the JAX leaf at ``path`` (``blocks``
    stacked on [L]: layer 0), and the map from JAX's axes to the port's."""
    parts = path.split("/")
    stacked = parts[0] == "blocks"
    if stacked:
        parts.insert(1, "0")
        shape = shape[1:]
    axes = list(range(len(shape)))
    linear = parts[-1] == "kernel" or (parts[0] == "blocks" and parts[2] in ("attn", "ffn")
                                       and len(shape) == 2 and parts[-1] != "bias")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    if linear:  # [in, out] -> [out, in]
        shape, axes = shape[::-1], axes[::-1]
    return "/".join(parts), tuple(shape), axes, int(stacked)


def _check_rules(tree, fsdp):
    JM._MESH = _FakeMesh(fsdp)
    try:
        checked = sharded = 0
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            path, shape = JM._path_str(kp), tuple(leaf.shape)
            spec = tuple(JM.param_pspec(kp, leaf))
            jax_axis = next((i for i, ax in enumerate(spec) if ax == "fsdp"), None)
            tpath, tshape, axes, off = _port_leaf(path, shape)
            want = None if jax_axis is None else axes.index(jax_axis - off)
            assert TM.shard_dim(tpath, tshape, fsdp) == want, (path, spec, tpath, tshape)
            checked += 1
            sharded += want is not None
        return checked, sharded
    finally:
        JM._MESH = None


@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_rules_match_jax_param_pspec(fsdp):
    """Every leaf of the tiny DiT, the 1.3B DiT (shapes only) and the tiny
    umT5 gets the dim JAX's rule gives it, a non-dividing dim replicated."""
    tiny = jax.eval_shape(lambda: JD.init_dit_params(jax.random.PRNGKey(0), j_tiny(),
                                                     jnp.float32))
    big = jax.eval_shape(lambda: JD.init_dit_params(jax.random.PRNGKey(0), JDiTConfig(),
                                                    jnp.bfloat16))
    t5 = jax.eval_shape(lambda: JT5.init_t5_params(jax.random.PRNGKey(0),
                                                   JT5.tiny_t5_config()))
    for tree in (tiny, big, t5):
        checked, sharded = _check_rules(tree, fsdp)
        assert checked > 10 and sharded > 0


def test_rules_on_the_port_layout():
    """The port's own paths: q/k/v and fc1 rows, o and fc2 columns, the
    text embedding's d_in; a dim the axis does not divide is replicated."""
    assert TM.shard_dim("blocks/3/self_attn/q/weight", (1536, 1536), 4) == 0
    assert TM.shard_dim("blocks/3/cross_attn/v/bias", (1536,), 4) == 0
    assert TM.shard_dim("blocks/3/self_attn/o/weight", (1536, 1536), 4) == 1
    assert TM.shard_dim("blocks/0/ffn/fc1/weight", (8960, 1536), 4) == 0
    assert TM.shard_dim("blocks/0/ffn/fc2/weight", (1536, 8960), 4) == 1
    assert TM.shard_dim("text_embedding/fc1/weight", (1536, 4096), 4) == 1
    assert TM.shard_dim("time_projection/fc/weight", (9216, 1536), 4) == 0
    assert TM.shard_dim("blocks/0/ffn/fc1/weight", (8960, 1536), 3) is None  # 8960 % 3
    assert TM.shard_dim("blocks/0/modulation", (6, 1536), 4) is None
    assert TM.shard_dim("blocks/0/self_attn/q/weight", (1536, 1536), 1) is None


def _jax_mesh(sp):
    return JM.make_mesh(dp=1, fsdp=1, sp=sp, devices=jax.devices()[:sp])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's side on 4 gloo ranks and, while they run, the JAX side."""
    jcfg = j_tiny()
    tree = random_tree(jax.eval_shape(lambda: JD.init_dit_params(
        jax.random.PRNGKey(0), jcfg, jnp.float32, zero_head=False)), 0)
    rng = np.random.default_rng(11)
    b, s, n, d = 2, 48, jcfg.num_heads, jcfg.head_dim
    qkv = [rng.standard_normal((b, s, n, d)).astype(np.float32) for _ in range(3)]
    x = rng.standard_normal((2, 3, 4, 8, 8)).astype(np.float32)
    t = np.asarray([900.0, 250.0], np.float32)
    pe = rng.standard_normal((2, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    cross = JD.prepare_cross_kv(params, jcfg, jnp.asarray(pe), jnp.float32)
    args = dict(tree=tree, qkv=qkv, x=x, t=t, cross=(np.asarray(cross.k), np.asarray(cross.v)))
    started = start_ranks(4, "torch_dist_cases", "parallel_cases", args,
                          tmp_path_factory.mktemp("parallel"))
    want = {}
    for sp in (2, 4):
        fn = shard_map(functools.partial(JS.ulysses_attention, axis_name="sp", impl="xla"),
                       mesh=_jax_mesh(sp), in_specs=(P(None, "sp"),) * 3,
                       out_specs=P(None, "sp"), check_vma=False)
        want[f"ulysses_{sp}"] = np.asarray(fn(*(jnp.asarray(z) for z in qkv)))
        want[f"bidi_{sp}"] = np.asarray(JS.sp_bidirectional_forward(
            params, jcfg, j_rope_tables(jcfg.head_dim, jcfg.rope_max_pos), _jax_mesh(sp),
            jnp.asarray(x), jnp.asarray(t), cross, attn_impl="xla"))
    return want, started.results()


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_attention_matches_jax(ranks, sp):
    want, out = ranks
    for r in range(4):  # every rank of every group holds the same gathered output
        np.testing.assert_allclose(out[r][f"ulysses_{sp}"], want[f"ulysses_{sp}"], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_bidirectional_forward_matches_jax(ranks, sp):
    want, out = ranks
    for r in range(4):
        np.testing.assert_allclose(out[r][f"bidi_{sp}"], want[f"bidi_{sp}"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fsdp", [2, 4])
def test_shard_gather_round_trip(ranks, fsdp):
    """Gathered shards are the tree bit for bit; one rank's shards hold
    fewer elements than the tree."""
    _, out = ranks
    for r in range(4):
        assert out[r][f"roundtrip_{fsdp}"]
        assert out[r][f"numel_{fsdp}"] < out[r]["numel"]
