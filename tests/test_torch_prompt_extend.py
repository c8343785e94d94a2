"""The port's prompt extension (``utils/prompt_extend.py``): the
counterparts of the JAX package's tests in ``tests/test_io_utils.py``, and
the system prompts and name map equal to the JAX package's.  No model is
loaded: the Qwen expander defers loading, DashScope needs its package."""

import pytest

from longlive_torch.utils import prompt_extend as pe
from longlive_tpu.utils import prompt_extend as jpe


def test_identity_rewriter():
    assert pe.get_rewriter("identity")("a cat") == "a cat"
    with pytest.raises(ValueError, match="unknown prompt rewriter"):
        pe.get_rewriter("nope")


def test_system_prompts_match_jax():
    for name in ("LM_EN_SYS_PROMPT", "LM_ZH_SYS_PROMPT", "VL_EN_SYS_PROMPT", "VL_ZH_SYS_PROMPT"):
        assert getattr(pe, name) == getattr(jpe, name)
    assert pe.QwenPromptExpander.model_dict == jpe.QwenPromptExpander.model_dict


def test_prompt_expander_system_prompts_and_dispatch():
    lm = pe.PromptExpander("m", is_vl=False)
    vl = pe.PromptExpander("m", is_vl=True)
    assert lm.decide_system_prompt("en") == pe.LM_EN_SYS_PROMPT
    assert lm.decide_system_prompt("ch") == pe.LM_ZH_SYS_PROMPT
    assert lm.decide_system_prompt("zh") == pe.LM_ZH_SYS_PROMPT
    assert vl.decide_system_prompt("en") == pe.VL_EN_SYS_PROMPT
    assert vl.decide_system_prompt("ch") == pe.VL_ZH_SYS_PROMPT

    calls = []

    class Fake(pe.PromptExpander):
        def extend(self, prompt, system_prompt, seed=-1, *a, **k):
            calls.append(("lm", prompt, seed))
            return pe.PromptOutput(True, prompt + "!", seed, system_prompt, "")

        def extend_with_img(self, prompt, system_prompt, image=None, seed=-1, *a, **k):
            calls.append(("vl", prompt, image))
            return pe.PromptOutput(True, prompt + "?", seed, system_prompt, "")

    out = Fake("m")("a dog", tar_lang="en", seed=7)
    assert out.status and out.prompt == "a dog!" and out.seed == 7
    out = Fake("m", is_vl=True)("a dog", image="img.png", seed=1)
    assert out.prompt == "a dog?" and calls[-1] == ("vl", "a dog", "img.png")
    out.add_custom_field("extra", 3)
    assert out.extra == 3
    assert Fake("m")("x").seed >= 0  # seed < 0 becomes a random non-negative one
    with pytest.raises(NotImplementedError, match="image"):
        Fake("m", is_vl=True)("a dog")
    with pytest.raises(NotImplementedError):
        pe.PromptExpander("m")("a dog")


def test_qwen_expander_name_map_and_lazy():
    q = pe.QwenPromptExpander("Qwen2.5_7B")
    assert q.model_name == "Qwen/Qwen2.5-7B-Instruct"
    assert q._model is None and q._tok is None  # nothing loaded yet
    assert pe.QwenPromptExpander(is_vl=True).model_name == "Qwen/Qwen2.5-VL-7B-Instruct"
    assert pe.QwenPromptExpander().model_name == "Qwen/Qwen2.5-14B-Instruct"
    assert pe.QwenPromptExpander("/no/such/dir").model_name == "/no/such/dir"


def test_dashscope_expander_without_its_package_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "dashscope", None)
    for mod in (pe, jpe):
        with pytest.raises(ImportError, match="dashscope"):
            mod.DashScopePromptExpander()
