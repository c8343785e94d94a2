"""The port's dp x fsdp training (``ScoreDistillationTrainer(mesh=...)``)
held against the JAX package's sharded step on the CPU.

On 4 gloo ranks, spawned once for the module (dp 2 x fsdp 2, the global
batch of 2 split over dp):

- one DMD step (generator and critic) against the JAX trainer's step on
  its dp 2 x fsdp 2 mesh of the 8-device CPU mesh, the JAX draws replayed
  (the trainer's draws are the global batch's on every rank), at JAX's own
  sharded-step losses at JAX's own tolerance (``tests/test_training.py``,
  rtol 2e-4); the global gradient norms and each trained leaf's gradient
  (AdamW's first moment, gathered whole: with beta1 0 it is the gradient
  reduced over the ranks and clipped) against JAX's at the single-process
  step's 5e-4 (``tests/test_torch_train_step.py``); and each parameter
  leaf's change, within 1e-3 of its norm, against the AdamW step those
  moments make.  The learning rates are raised, as in the single-process
  test, so that the change dominates float32 rounding: a shard left
  unchanged, or given another slice's or the wrong sign's gradient, fails.
  (An element-wise check of the parameters against JAX's, its rtol 2e-3 /
  atol 2e-5, passes anything at the shipped 2e-6; at 1e-3 the few elements
  whose gradient is near AdamW's eps make it hang on the roundoff of those
  gradients.)
- the checkpoint of that state, written by rank 0 from the gathered
  trees, loaded back on the 4 ranks (their shards bit-equal) and on one
  process here (the whole trees bit-equal);
- two streaming steps at dp 2 against the same two steps of the port's
  single-process streaming trainer on the whole batch (the draws are the
  global batch's on every rank), at the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import tiny_dit_config, tiny_geometry
from longlive_torch.training import dmd as tdmd
from longlive_torch.training.streaming import StreamingConfig, StreamingTrainer
from longlive_torch.training.trainer import (PhaseDraws, ScoreDistillationTrainer, StepDraws,
                                             TrainerConfig)
from longlive_torch.training.trainer import TrainerConfig as TC
from longlive_torch.utils import train_state
from longlive_torch.utils.memory import param_leaves
from longlive_torch.utils.params import dit_params_from_jax
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.parallel import mesh as JM
from longlive_tpu.training import rollout as jro
from longlive_tpu.training.trainer import ScoreDistillationTrainer as JTrainer
from longlive_tpu.training.trainer import TrainerConfig as JTrainerConfig

from test_torch_train_step import UPDATE_TOL, jax_rollout_draws, jax_score_draws
from torch_dist import random_tree, start_ranks

LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-6  # tests/test_training.py's sharded step
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
GRAD_TOL = 5e-4  # tests/test_torch_train_step.py: grad norms through a whole rollout

_KW = dict(num_frame_per_block=1, num_training_frames=3, slice_last_frames=3,
           dfake_gen_update_ratio=1, lr=1e-3, lr_critic=3e-4)
_STREAM = dict(chunk_size=3, max_length=12, min_new_frame=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, geom = j_tiny(), tiny_geometry()
    shapes = jax.eval_shape(lambda: JD.init_dit_params(jax.random.PRNGKey(0), jcfg,
                                                       jnp.float32, zero_head=False))
    trees = [random_tree(shapes, i) for i in range(3)]  # generator, critic, teacher
    rng = np.random.default_rng(21)
    noise = rng.standard_normal((2, 3, geom.channels, geom.height, geom.width)).astype(np.float32)
    pe_c = rng.standard_normal((2, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    pe_u = (pe_c * 0.1).astype(np.float32)

    # the JAX sharded step, and its draws replayed for the port
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the JAX trainer donates)
    mesh = JM.make_mesh(dp=2, fsdp=2, sp=1, devices=jax.devices()[:4])
    jtr = JTrainer(JTrainerConfig(**_KW, attn_impl="xla"), jcfg, geom,
                   *(JM.shard_params(copy(t), mesh) for t in trees), mesh=mesh)
    key = jax.random.PRNGKey(23)
    r_exit, r_len, r_g, r_exit2, r_len2, r_c = jax.random.split(jax.random.fold_in(key, 0), 6)
    dcfg = tdmd.DMDConfig(timestep_shift=5.0)

    def phase(r_exit, r_len, r_phase):
        exit_idx, nb, _ = jtr._sample_rollout_geometry(jnp.asarray(noise), r_exit, r_len)
        r_roll, r_second = jax.random.split(r_phase)
        lo, hi = tdmd.score_timestep_range(dcfg, *jro.denoised_timestep_bounds(
            jtr.sched, jtr.rcfg, exit_idx))
        st, sn = jax_score_draws(r_second, (2, nb) + noise.shape[2:], lo, hi)
        return PhaseDraws(exit_idx, nb,
                          jax_rollout_draws(r_roll, nb, exit_idx, (2, 1) + noise.shape[2:]),
                          st, sn)

    draws = StepDraws(generator=phase(r_exit, r_len, r_g), critic=phase(r_exit2, r_len2, r_c))
    logdir = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    args = dict(trees=trees, noise=noise, pe_c=pe_c, pe_u=pe_u, draws=draws, tcfg=_KW,
                stream=_STREAM, logdir=logdir)
    ranks = start_ranks(4, "torch_dist_cases", "fsdp_cases", args,
                        tmp_path_factory.mktemp("fsdp"))
    bs = JM.batch_sharding(mesh)  # while the ranks run: the JAX step, one process's streaming
    jm = jtr.train_step(*(jax.device_put(jnp.asarray(x), bs) for x in (noise, pe_c, pe_u)), key)
    tr = StreamingTrainer(TrainerConfig(**_KW), tiny_dit_config(), tiny_geometry(),
                          *(dit_params_from_jax(t) for t in trees), device="cpu",
                          streaming_cfg=StreamingConfig(**_STREAM))
    tr.start_new_sequence(torch.from_numpy(pe_c), torch.from_numpy(pe_u))
    stream = [tr.streaming_train_step() for _ in range(2)]
    return dict(args=args, jm=jm, jtr=jtr, stream=stream, stream_tr=tr, out=ranks.results())


def _changes_match(got, want, before, what):
    """Each leaf's change from ``before`` against the wanted change, within
    UPDATE_TOL of its norm (all numpy, in ``param_leaves`` order)."""
    for i, (g, w, p0) in enumerate(zip(got, want, before)):
        err = np.linalg.norm(g - w) / np.linalg.norm(w - p0)
        assert err <= UPDATE_TOL, f"{what} leaf {i}: change off by {err:.2e} (relative)"


def _before(setup, i):
    return [t.numpy() for t in param_leaves(dit_params_from_jax(setup["args"]["trees"][i]))]


def _jax_first_moments(opt_state):
    """optax AdamW's first moment of a JAX optimiser state, as the port's
    leaves (numpy)."""
    (mu,) = [s.mu for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
             if hasattr(s, "mu")]
    return [t.numpy() for t in param_leaves(dit_params_from_jax(jax.tree.map(np.asarray, mu)))]


def _adamw_first_step(before, moments, lr, b2):
    """The parameters after AdamW's first step from ``moments`` (beta1 0:
    the first moment is the gradient), eps and decay as the trainer's."""
    return [p0 - lr * (m / (np.sqrt(v / (1 - b2)) + 1e-8) + TC.weight_decay * p0)
            for p0, (m, v) in zip(before, moments)]


def test_dmd_step_matches_jax_sharded_step(setup):
    s = setup
    for r in range(4):
        m = s["out"][r]["metrics"]
        assert (m["exit_idx"], m["critic_exit_idx"]) == (s["jm"]["exit_idx"],
                                                         s["jm"]["critic_exit_idx"])
        for k in ("generator_loss", "critic_loss"):
            np.testing.assert_allclose(m[k], float(s["jm"][k]), rtol=LOSS_RTOL, atol=LOSS_ATOL)
        for k in ("generator_grad_norm", "critic_grad_norm"):  # the reduced gradients
            np.testing.assert_allclose(m[k], float(s["jm"][k]), rtol=GRAD_TOL, atol=GRAD_TOL)
        assert m == s["out"][0]["metrics"]  # the global means, the same on every rank
    rates = dict(gen=(_KW["lr"], TC.beta2), critic=(_KW["lr_critic"], TC.beta2_critic))
    for i, got in enumerate(("gen", "critic")):
        grads = _jax_first_moments(s["jtr"].state[got + "_opt"])
        p0 = _before(s, i)
        for r in range(4):
            moments = s["out"][r][got + "_moments"]
            for (m, _), w in zip(moments, grads):
                np.testing.assert_allclose(m, w, rtol=GRAD_TOL,
                                           atol=GRAD_TOL * max(np.abs(w).max(), 1e-3))
            _changes_match(s["out"][r][got], _adamw_first_step(p0, moments, *rates[got]), p0,
                           f"rank {r} {got}")
    for r in range(4):  # no gathered tree outlives its phase
        assert s["out"][r]["gathered_after"] == 0


def test_each_rank_holds_a_shard_at_rest(setup):
    whole = sum(t.size for t in setup["out"][0]["gen"])
    for r in range(4):
        assert setup["out"][r]["shard_numel"] < 0.6 * whole


def test_checkpoint_from_four_ranks_loads_on_four_and_on_one(setup):
    s = setup
    for r in range(4):
        assert s["out"][r]["reload_equal"] and s["out"][r]["opt_equal"]
    one = ScoreDistillationTrainer(TrainerConfig(**_KW), tiny_dit_config(), tiny_geometry(),
                                   *(dit_params_from_jax(t) for t in s["args"]["trees"]),
                                   device="cpu")
    one.load_state_dict(train_state.restore_train_state(s["args"]["logdir"]))
    assert one.state["step"] == 1
    for a, b in zip(param_leaves(one.state["gen_params"]), s["out"][0]["gen"]):
        assert np.array_equal(a.detach().numpy(), b)
    for p, st in one.gen_opt.state.items():  # AdamW's moments are whole tensors
        assert st["exp_avg_sq"].shape == p.shape


def test_streaming_at_dp2_matches_one_process(setup):
    s = setup
    want, tr = s["stream"], s["stream_tr"]
    for r in range(4):
        for got, w in zip(s["out"][r]["stream"], want):
            assert got["current_length"] == w["current_length"]
            for k in ("generator_loss", "critic_loss"):
                if k in w:
                    np.testing.assert_allclose(got[k], w[k], rtol=LOSS_RTOL, atol=LOSS_ATOL)
        one = [t.detach().numpy() for t in param_leaves(tr.state["gen_params"])]
        for a, b in zip(s["out"][r]["stream_gen"], one):
            np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        _changes_match(s["out"][r]["stream_gen"], one, _before(s, 0), f"rank {r} generator")
        assert s["out"][r]["stream_gathered_after"] == 0
