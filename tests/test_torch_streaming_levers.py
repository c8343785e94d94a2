"""The streaming trainer with the single-card training levers held against
the JAX package's, float32 on the CPU at the tiny config, the JAX
trainer's draws replayed (the harness of ``tests/test_torch_streaming.py``;
a file of its own so that its JAX runs spread over the test workers)."""

import pytest
import torch

from longlive_torch.training.trainer import map_tree, param_leaves
from longlive_torch.utils.params import lora_params_from_jax
from test_torch_streaming import build_trainers, models, run_streaming_steps  # noqa: F401
from test_torch_train_step import check_updates

LEVER_CASES = {
    "host optimiser": dict(opt_on_host=True, opt_async=True, staged_phases=True,
                           teacher_stream=True, page_generator=True),
    "accumulation": dict(gradient_accumulation_steps=2, dfake_gen_update_ratio=1),
}


@pytest.mark.parametrize("case", list(LEVER_CASES))
def test_streaming_levers_match_jax(models, case):  # noqa: F811
    """The ``lora`` case of ``test_streaming_steps_match_jax`` (rank-4
    adapters on both models, the JAX trainer's carried across) with levers
    on, in both trainers.

    ``host optimiser``: AdamW on the host with the critic's update in the
    background (its grad norm a step late in both), the teacher's blocks
    streamed from the host and the critic's base paged (``staged_phases``,
    ``teacher_stream``), the generator paged out (the JAX streaming
    trainer has no ``page_generator``: its results are the same); 3 steps.
    ``accumulation``: two micro-steps per update and the generator on every
    optimiser step, 4 steps: the updates land on steps 1 and 3 (one update
    alone would move the generator's A matrices by their weight decay only,
    B being 0: float32 rounding of that decay is not what this test holds).

    Losses, grad norms, the chunk state, the previous frames and the cache
    at every step, then the change of every adapter against the JAX
    trainer, the bases untouched."""
    jtr, ttr = build_trainers(models, lora=True, options=LEVER_CASES[case],
                              train_first_chunk=True)
    trained = [(k, lora_params_from_jax, map_tree(lambda t: t.detach().clone(), ttr.state[k]))
               for k in ("gen_lora", "critic_lora")]
    bases = {k: map_tree(lambda t: t.detach().clone(), ttr.state[k])
             for k in ("gen_params", "critic_params")}
    ms = run_streaming_steps(jtr, ttr, 4 if case == "accumulation" else 3)
    if case == "host optimiser":
        jtr.finish_pending()
        ttr.finish_pending()
        assert "critic_grad_norm" not in ms[0] and "critic_grad_norm" in ms[1]
    else:
        assert [m["opt_step"] for m in ms] == [0, 0, 1, 1]
        assert all("generator_loss" in m for m in ms)
    check_updates(jtr, ttr, trained)
    for k, before in bases.items():
        assert all(torch.equal(a, b) for a, b in zip(param_leaves(ttr.state[k]),
                                                      param_leaves(before)))
