"""The port's checkpoint conversion and the loaders' file branches, held
against the JAX package's converters on synthetic state dicts in the
reference's key layout (the port's random parameters written out by
``dit_state_dict`` / ``vae_state_dict``).  The oracle is
``dit_params_from_jax(JAX dit_params_from_torch(sd))`` (and the same for
the VAE): every tree must be equal bit for bit, in float32 and in bf16."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longlive_torch.config import PipelineConfig, tiny_dit_config
from longlive_torch.models import dit as TD
from longlive_torch.models import vae as TV
from longlive_torch.utils import checkpoint as TC
from longlive_torch.utils import loading
from longlive_torch.utils.params import dit_params_from_jax, vae_params_from_jax
from longlive_tpu.config import tiny_dit_config as j_tiny
from longlive_tpu.models import dit as JD
from longlive_tpu.models import vae as JV
from longlive_tpu.utils import checkpoint as JC

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def assert_trees_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {sorted(set(got) ^ set(want))}"
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (
            f"{path}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
        assert torch.equal(got, want), f"{path} differs"


def _jax_to_port(tree, convert, dtype):
    """A JAX tree -> the port's layout in ``dtype`` (through float32 numpy,
    exact for bf16 leaves)."""
    return convert(jax.tree.map(lambda a: np.asarray(a, np.float32), tree), dtype)


def _dit_sd(seed=1):
    cfg = tiny_dit_config()
    assert cfg.qk_norm and cfg.cross_attn_norm and cfg.rope_layout == "halfsplit"
    params = TD.init_dit_params(cfg, torch.float32, "cpu", seed=seed, zero_head=False)
    return cfg, params, TC.dit_state_dict(params, cfg)


LORA_TARGETS = ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o", "cross_attn.q",
                "cross_attn.v", "ffn.0", "ffn.2")


def _lora_sd(sd, rank=4, prefix="base_model.model.", default=True, seed=2):
    """A PEFT adapter over every block's attention and FFN linears:
    A [r, in], B [out, r]."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    num_layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(num_layers):
        for t in LORA_TARGETS:
            o, n = sd[f"blocks.{i}.{t}.weight"].shape
            d = ".default" if default else ""
            out[f"{prefix}blocks.{i}.{t}.lora_A{d}.weight"] = torch.randn((rank, n), generator=g)
            out[f"{prefix}blocks.{i}.{t}.lora_B{d}.weight"] = torch.randn((o, rank), generator=g)
    return out


# ---------------------------------------------------------------------------
# key cleaning and unwrapping


@pytest.mark.parametrize("layout,use_ema", [("generator", False), ("generator_ema", True),
                                            ("generator", True), ("model", False),
                                            ("raw", False)])
def test_clean_and_unwrap_match_jax(layout, use_ema):
    sd = {"_fsdp_wrapped_module.blocks.0.ffn.0.weight": torch.ones(2, 2),
          "module.head.head.bias": torch.zeros(3),
          "blocks.1.modulation": torch.full((1, 6, 2), 2.0)}
    ckpt = sd if layout == "raw" else {layout: sd, "step": 7}
    if layout == "generator_ema":
        ckpt["generator"] = {"other": torch.zeros(1)}
    got = TC.unwrap_generator_checkpoint(ckpt, use_ema=use_ema)
    want = JC.unwrap_generator_checkpoint(ckpt, use_ema=use_ema)
    assert list(got) == list(want)
    assert set(got) == {"blocks.0.ffn.0.weight", "head.head.bias", "blocks.1.modulation"}
    assert all(got[k] is want[k] for k in got)
    assert list(TC.clean_state_dict_keys(sd)) == list(JC.clean_state_dict_keys(sd))


# ---------------------------------------------------------------------------
# the LoRA fold


@pytest.mark.parametrize("prefix,default", [("base_model.model.", True),
                                            ("base_model.model.", False), ("", True), ("", False)])
@pytest.mark.parametrize("base_dtype", [torch.float32, torch.bfloat16])
def test_fold_lora_bit_equal_to_jax(prefix, default, base_dtype):
    _, _, sd = _dit_sd()
    sd = {k: v.to(base_dtype) for k, v in sd.items()}
    lora = _lora_sd(sd, prefix=prefix, default=default)
    got = TC.fold_lora_into_dit_sd(sd, lora, alpha_over_rank=0.5)
    want = JC.fold_lora_into_dit_sd(sd, lora, alpha_over_rank=0.5)
    assert set(got) == set(want)
    folded = {k for k in got if any(f".{t}.weight" in k for t in LORA_TARGETS)}
    assert len(folded) == 2 * len(LORA_TARGETS)
    for k in got:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k
        if k in folded:
            assert got[k].dtype == torch.float32
            assert not torch.equal(got[k], sd[k].float())


def test_fold_lora_missing_target_raises():
    _, _, sd = _dit_sd()
    lora = {"base_model.model.blocks.9.self_attn.q.lora_A.default.weight": torch.ones(2, 96),
            "base_model.model.blocks.9.self_attn.q.lora_B.default.weight": torch.ones(96, 2)}
    with pytest.raises(KeyError, match="blocks.9.self_attn.q.weight"):
        TC.fold_lora_into_dit_sd(sd, lora)
    with pytest.raises(KeyError):
        JC.fold_lora_into_dit_sd(sd, lora)


# ---------------------------------------------------------------------------
# the converters


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["float32", "bf16"])
def test_dit_params_from_torch_matches_jax(dtype, jdtype):
    """Tiny config with qk_norm and cross_attn_norm: modulation loses its
    leading axis, the patch embedding flattens in patchify's order, the
    halfsplit permutation is applied once; the JAX tree's shapes are those
    of the JAX package's own init."""
    cfg, params, sd = _dit_sd()
    jtree = JC.dit_params_from_torch(sd, j_tiny(), jdtype)
    jinit = jax.eval_shape(lambda: JD.init_dit_params(jax.random.PRNGKey(0), j_tiny(),
                                                      jnp.float32))
    assert jax.tree.map(jnp.shape, jtree) == jax.tree.map(jnp.shape, jinit)
    got = TC.dit_params_from_torch(sd, cfg, dtype)
    assert_trees_equal(got, _jax_to_port(jtree, dit_params_from_jax, dtype))
    if dtype == torch.float32:
        assert_trees_equal(got, params)  # the round trip through the reference layout


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["float32", "bf16"])
@pytest.mark.parametrize("vcfg", [TV.tiny_vae_config(), TV.VAEConfig(dim=8),
                                  dataclasses.replace(TV.tiny_vae_config(), dim=96)],
                         ids=["tiny", "dim8", "tiny96"])
def test_vae_params_from_torch_matches_jax(vcfg, dtype, jdtype):
    """Encoder and decoder (gammas [C, 1, 1, 1] -> [C]), both 1x1x1 convs,
    and at width 96 the packed weights of the fused convs."""
    params = TV.init_vae_params(vcfg, torch.float32, "cpu", seed=3)
    sd = TC.vae_state_dict(params, vcfg)
    assert sd["encoder.head.0.gamma"].shape == (vcfg.dim * vcfg.dim_mult[-1], 1, 1, 1)
    jcfg = JV.VAEConfig(**{f: getattr(vcfg, f) for f in vcfg.__dataclass_fields__})
    jtree = JC.vae_params_from_torch(sd, jcfg, jdtype)
    jinit = jax.eval_shape(lambda: JV.init_vae_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    assert jax.tree.map(jnp.shape, jtree) == jax.tree.map(jnp.shape, jinit)
    got = TC.vae_params_from_torch(sd, vcfg, dtype)
    assert_trees_equal(got, _jax_to_port(jtree, vae_params_from_jax, dtype))
    if dtype == torch.float32:
        assert_trees_equal(got, params)


# ---------------------------------------------------------------------------
# the loaders' file branches


def test_load_dit_params_reads_generator_and_folds_lora(tmp_path, monkeypatch):
    """``{"generator": sd}`` with FSDP prefixes in bf16, a ``{"generator_lora":
    ...}`` adapter folded at the YAML's alpha / rank = 0.5; and the EMA
    weights under ``use_ema``."""
    monkeypatch.chdir(tmp_path)
    cfg, _, sd = _dit_sd()
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    _, _, ema = _dit_sd(seed=5)
    lora = _lora_sd(sd)
    torch.save({"generator": {f"_fsdp_wrapped_module.{k}": v for k, v in sd.items()},
                "generator_ema": ema, "step": 3}, tmp_path / "gen.pt")
    torch.save({"generator_lora": lora}, tmp_path / "lora.pt")
    pc = PipelineConfig(generator_ckpt="gen.pt", lora_ckpt="lora.pt",
                        extras={"adapter": {"type": "lora", "rank": 4, "alpha": 2}})
    for dtype, jdtype in DTYPES:
        got = loading.load_dit_params(pc, cfg, dtype, "cpu")
        folded = TC.fold_lora_into_dit_sd(sd, lora, alpha_over_rank=0.5)
        assert_trees_equal(got, TC.dit_params_from_torch(folded, cfg, dtype))
        jwant = JC.dit_params_from_torch(JC.fold_lora_into_dit_sd(sd, lora, 0.5), j_tiny(), jdtype)
        assert_trees_equal(got, _jax_to_port(jwant, dit_params_from_jax, dtype))
    pc_ema = PipelineConfig(generator_ckpt="gen.pt")
    assert_trees_equal(loading.load_dit_params(pc_ema, cfg, torch.float32, "cpu", use_ema=True),
                       TC.dit_params_from_torch(ema, cfg, torch.float32))


@pytest.mark.parametrize("layout", ["pth", "safetensors_index", "safetensors_files"])
def test_load_base_dit_file_branches(tmp_path, layout):
    """A ``.pth`` state dict, a sharded safetensors directory with its index
    (the released layout), and a directory of safetensors files without
    one: each equal to a direct conversion."""
    from safetensors.torch import save_file

    cfg, _, sd = _dit_sd(seed=4)
    sd = {k: v.contiguous().clone() for k, v in sd.items()}
    if layout == "pth":
        path = tmp_path / "base.pth"
        torch.save(sd, path)
    else:
        path = tmp_path / "Wan2.1-T2V-1.3B"
        path.mkdir()
        keys = sorted(sd)
        shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": keys[::2],
                  "diffusion_pytorch_model-00002-of-00002.safetensors": keys[1::2]}
        for name, ks in shards.items():
            save_file({k: sd[k] for k in ks}, str(path / name))
        if layout == "safetensors_index":
            index = {"metadata": {}, "weight_map": {k: n for n, ks in shards.items() for k in ks}}
            (path / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(index))
    got = loading.load_base_dit(str(path), cfg, torch.float32, "cpu")
    assert_trees_equal(got, TC.dit_params_from_torch(sd, cfg, torch.float32))


def test_load_vae_params_reads_the_wan_vae(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    vcfg = TV.VAEConfig(dim=8)
    sd = TC.vae_state_dict(TV.init_vae_params(vcfg, torch.float32, "cpu", seed=6), vcfg)
    pc = PipelineConfig()
    os.makedirs(os.path.join("wan_models", pc.model_name))
    torch.save(sd, os.path.join("wan_models", pc.model_name, "Wan2.1_VAE.pth"))
    for dtype in (torch.float32, torch.bfloat16):
        got, cfg_out = loading.load_vae_params(pc, dtype, "cpu", vcfg=vcfg)
        assert cfg_out == vcfg
        assert_trees_equal(got, TC.vae_params_from_torch(sd, vcfg, dtype))


def test_absent_files_and_strict(tmp_path, monkeypatch, capsys):
    """Absent artifacts still give the seeded random init with a warning
    (an empty directory counts as absent), and FileNotFoundError under
    ``strict``."""
    monkeypatch.chdir(tmp_path)
    cfg = tiny_dit_config()
    (tmp_path / "empty").mkdir()
    for where in ("absent", "empty"):
        got = loading.load_base_dit(str(tmp_path / where), cfg, torch.float32, "cpu", seed=4)
        assert_trees_equal(got, TD.init_dit_params(cfg, torch.float32, "cpu", seed=4))
        with pytest.raises(FileNotFoundError):
            loading.load_base_dit(str(tmp_path / where), cfg, torch.float32, "cpu", strict=True)
    pc = PipelineConfig(generator_ckpt="absent.pt", lora_ckpt="absent_lora.pt", seed=2)
    assert_trees_equal(loading.load_dit_params(pc, cfg, torch.float32, "cpu"),
                       TD.init_dit_params(cfg, torch.float32, "cpu", seed=2))
    assert capsys.readouterr().err.count("WARNING") == 3
