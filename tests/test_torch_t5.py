"""The port's umT5 encoder held against the JAX package's on the tiny T5
config, float32 on the CPU, the same parameters (carried across by
``utils.params.t5_params_from_jax``) and token ids: the bucket ids, the
norm, the encode (resident and streamed), the converter, the text-encoder
facade in both memory modes, and ``run_inference``'s text-encoder branch."""

import dataclasses

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from longlive_torch import run_inference
from longlive_torch.models import t5 as TT5
from longlive_torch.pipeline import CausalInferencePipeline
from longlive_torch.utils import checkpoint as TC
from longlive_torch.utils import loading
from longlive_torch.utils.params import t5_params_from_jax
from longlive_tpu.models import t5 as JT5

RTOL = 1e-5  # float32, relative to the features' largest magnitude


def _cfgs():
    jcfg = JT5.tiny_t5_config()
    return jcfg, TT5.T5Config(**dataclasses.asdict(jcfg))


def _params():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, JT5.init_t5_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    return jcfg, tcfg, tree, t5_params_from_jax(tree)


def _ids(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (len(lengths), cfg.text_len)).astype(np.int32)
    mask = (np.arange(cfg.text_len)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids * mask, mask


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err


class StubTokenizer(chip_smoke.StubTokenizer):
    """``chip_smoke``'s stub tokenizer (each character one id), recording
    the ids and masks it gave."""

    def __init__(self, vocab):
        super().__init__(vocab)
        self.calls = []

    def __call__(self, texts, **kw):
        enc = super().__call__(texts, **kw)
        self.calls.append((enc["input_ids"], enc["attention_mask"]))
        return enc


@pytest.mark.parametrize("lq,lk", [(1, 1), (7, 7), (16, 16), (40, 512), (512, 512)])
def test_relative_position_buckets_equal_jax(lq, lk):
    """Every id, the exact powers of two (rel 16, 32, 64) included."""
    want = np.asarray(JT5.relative_position_buckets(lq, lk, 32, 128))
    got = TT5.relative_position_buckets(lq, lk, 32, 128)
    assert got.shape == (lq, lk)
    np.testing.assert_array_equal(got.numpy(), want)


def test_t5_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 32)) * 3).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(JT5.t5_layer_norm(jnp.asarray(x), jnp.asarray(w)))
    got = TT5.t5_layer_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_t5_encode_and_encode_prompts_match_jax():
    """Ragged masks (the whole window, 5 tokens, 1 token): the features, and
    encode_prompts' zeroed padding rows."""
    jcfg, tcfg, tree, tparams = _params()
    ids, mask = _ids(tcfg, [tcfg.text_len, 5, 1])
    jp = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(JT5.t5_encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = TT5.t5_encode(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)
    want = np.asarray(JT5.encode_prompts(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = TT5.encode_prompts(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got, want)
    assert not got[1, 5:].any() and not got[2, 1:].any() and got[2, 0].abs().sum() > 0


def test_t5_encode_streamed_equals_resident():
    _, tcfg, _, tparams = _params()
    ids, mask = (torch.from_numpy(a) for a in _ids(tcfg, [9, 16], seed=2))
    host = TT5.pin_t5_params(tparams)
    assert torch.equal(TT5.t5_encode_streamed(host, tcfg, ids, mask),
                       TT5.t5_encode(tparams, tcfg, ids, mask))


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)], ids=["float32", "bf16"])
def test_t5_params_from_torch_matches_jax(dtype, jdtype):
    """A reference-layout state dict (the port's random parameters written
    out by ``t5_state_dict``, some keys behind ``module.``): the port's
    converter equals the JAX one's exactly, and round-trips."""
    jcfg, tcfg = _cfgs()
    params = TT5.init_t5_params(tcfg, torch.float32, "cpu", seed=3)
    sd = {("module." + k if "ffn" in k else k): v for k, v in TC.t5_state_dict(params).items()}
    got = TT5.t5_params_from_torch(sd, tcfg, dtype)
    want = t5_params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                           JT5.t5_params_from_torch(sd, jcfg, jdtype)), dtype)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype == dtype and torch.equal(g, w)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    if dtype == torch.float32:
        for g, p in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            assert torch.equal(g, p)


@pytest.mark.parametrize("low_memory", [False, True])
def test_text_encoder_matches_jax(low_memory):
    """The same stub tokenizer in both packages' ``T5TextEncoder``;
    ``offload`` keeps the port's output and streams afterwards."""
    jcfg, tcfg, tree, tparams = _params()
    prompts = ["a cat on a mat", "a red fox jumps over the lazy dog, in the snow at dusk"]
    jenc = JT5.T5TextEncoder(jax.tree.map(jnp.asarray, tree), jcfg, low_memory=low_memory)
    jenc.tokenizer = StubTokenizer(jcfg.vocab_size)
    tenc = TT5.T5TextEncoder(tparams, tcfg, low_memory=low_memory, device="cpu",
                             tokenizer=StubTokenizer(tcfg.vocab_size))
    want = np.asarray(jenc(prompts)["prompt_embeds"])
    got = tenc(prompts)["prompt_embeds"]
    _close(got, want)
    assert not got[0, len(prompts[0]):].any()
    tenc.offload()
    assert tenc.low_memory and torch.equal(tenc(prompts)["prompt_embeds"], got)


def test_run_inference_conditions_on_the_t5(tmp_path, monkeypatch):
    """``run_inference`` with a T5 (``load_text_encoder`` returning a tiny
    ``T5TextEncoder`` with the stub tokenizer): each prompt of the data
    file is conditioned on exactly ``encode_prompts`` of the stub's ids,
    all encoded before the first generation; the T5 is then offloaded."""
    monkeypatch.chdir(tmp_path)
    _, tcfg, _, tparams = _params()
    prompts = ["a lighthouse at night", "waves"]
    (tmp_path / "prompts.txt").write_text("\n".join(prompts) + "\n")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "tiny_debug": True, "model_kwargs": {"local_attn_size": 4, "sink_size": 1},
        "num_frame_per_block": 1, "num_output_frames": 2, "profile": False,
        "data_path": "prompts.txt", "output_folder": "out"}))
    tok = StubTokenizer(tcfg.vocab_size)
    enc = TT5.T5TextEncoder(tparams, tcfg, device="cpu", tokenizer=tok)
    monkeypatch.setattr(loading, "load_text_encoder", lambda *a, **k: enc)
    seen = []
    prepare = CausalInferencePipeline.prepare_condition

    def recording(self, pe):
        seen.append((pe.clone(), enc.low_memory))
        return prepare(self, pe)

    monkeypatch.setattr(CausalInferencePipeline, "prepare_condition", recording)
    recs = run_inference.main(["--config_path", str(cfg_path), "--device", "cpu"])
    assert len(recs) == len(seen) == len(tok.calls) == 2
    assert all(low for _, low in seen)  # every prompt encoded before generating
    for (pe, _), (ids, mask) in zip(seen, tok.calls):
        want = TT5.encode_prompts(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
        assert torch.equal(pe, want)
    for r in recs:
        assert tuple(r["latents"].shape[:2]) == (1, 2) and torch.isfinite(r["pixels"]).all()
