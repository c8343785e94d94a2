"""Prompt extension (the reference's wan/utils/prompt_extend.py).

LongLive's pipelines read pre-extended prompts from disk
(``extended_prompt_path``); the vanilla Wan path rewrites prompts with a
language model.  This module carries the whole expander surface:

- ``PromptExpander``: the system prompt by language (en / zh) and modality
  (text, or vision-language with an image), and ``__call__``'s dispatch;
- ``QwenPromptExpander``: a local Hugging Face Qwen chat model (text), or
  Qwen2.5-VL for image-conditioned extension.  The model loads at the first
  extension, from a local path or the Hugging Face cache;
- ``DashScopePromptExpander``: the hosted-API variant; constructing it needs
  the ``dashscope`` package (ImportError without it) and an API key;
- ``get_rewriter``: the functional interface the CLIs use.

``transformers`` and ``dashscope`` are imported where they are used, so
importing this module needs neither.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import sys
from typing import Callable, Optional

LM_EN_SYS_PROMPT = (
    "You are a prompt engineer for a text-to-video model. Rewrite the "
    "user's prompt into one detailed English video description of roughly "
    "80-100 words. Keep every stated subject, action and attribute; add "
    "concrete detail about motion, scene, lighting, camera movement and "
    "visual style; never change the meaning, never answer questions in the "
    "prompt, and output only the rewritten description."
)

LM_ZH_SYS_PROMPT = (
    "你是一个视频生成模型的提示词工程师。请把用户给出的提示词改写成一段"
    "细节丰富的中文视频描述，约八十到一百字。保留原有的主体、动作和属性；"
    "补充运动、场景、光线、镜头运动和画面风格等具体细节；不要改变原意，"
    "不要回答提示词中的问题，只输出改写后的描述。"
)

VL_EN_SYS_PROMPT = (
    "You are a prompt engineer for an image-to-video model. Using the "
    "provided image as the first frame, rewrite the user's prompt into one "
    "detailed English description (roughly 80-100 words) of the video that "
    "starts from this image. Describe what is visible in the image "
    "accurately, then the motion and camera work implied by the prompt. "
    "Never contradict the image, and output only the description."
)

VL_ZH_SYS_PROMPT = (
    "你是一个图生视频模型的提示词工程师。给定的图片是视频的第一帧，请结合"
    "图片内容把用户的提示词改写成一段约八十到一百字的中文视频描述：先准确"
    "描述图片中的内容，再描述提示词所暗示的运动和镜头。不得与图片内容矛盾，"
    "只输出改写后的描述。"
)


@dataclasses.dataclass
class PromptOutput:
    """Result record (prompt_extend.py:101-109)."""

    status: bool
    prompt: str
    seed: int
    system_prompt: str
    message: str

    def add_custom_field(self, key: str, value) -> None:
        setattr(self, key, value)


class PromptExpander:
    """Base expander (prompt_extend.py:112-155)."""

    def __init__(self, model_name, is_vl: bool = False, device=0, **kwargs):
        self.model_name = model_name
        self.is_vl = is_vl
        self.device = device

    def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
        raise NotImplementedError

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs):
        raise NotImplementedError

    def decide_system_prompt(self, tar_lang: str = "en") -> str:
        if tar_lang == "ch" or tar_lang == "zh":
            return LM_ZH_SYS_PROMPT if not self.is_vl else VL_ZH_SYS_PROMPT
        return LM_EN_SYS_PROMPT if not self.is_vl else VL_EN_SYS_PROMPT

    def __call__(self, prompt, tar_lang: str = "en", image=None, seed=-1,
                 *args, **kwargs) -> PromptOutput:
        system_prompt = self.decide_system_prompt(tar_lang=tar_lang)
        if seed < 0:
            seed = random.randint(0, sys.maxsize)
        if image is not None and self.is_vl:
            return self.extend_with_img(prompt, system_prompt, image=image,
                                        seed=seed, *args, **kwargs)
        if not self.is_vl:
            return self.extend(prompt, system_prompt, seed, *args, **kwargs)
        raise NotImplementedError("VL expander requires an image")


def _seed_torch(seed: int) -> None:
    """Reference parity (wan/utils/prompt_extend.py seeds torch before
    generate): a recorded PromptOutput.seed must actually reproduce the
    expansion under sampling generation configs."""
    if seed is not None and seed >= 0:
        import torch

        torch.manual_seed(seed)


class QwenPromptExpander(PromptExpander):
    """Local Qwen chat-LM expander (prompt_extend.py:300-465).

    Models load lazily on first extend, so constructing the expander is
    free; weights come from a local path or the HF cache.
    """

    model_dict = {
        "QwenVL2.5_3B": "Qwen/Qwen2.5-VL-3B-Instruct",
        "QwenVL2.5_7B": "Qwen/Qwen2.5-VL-7B-Instruct",
        "Qwen2.5_3B": "Qwen/Qwen2.5-3B-Instruct",
        "Qwen2.5_7B": "Qwen/Qwen2.5-7B-Instruct",
        "Qwen2.5_14B": "Qwen/Qwen2.5-14B-Instruct",
    }

    def __init__(self, model_name: Optional[str] = None, device=0,
                 is_vl: bool = False, max_new_tokens: int = 512, **kwargs):
        if model_name is None:
            model_name = "Qwen2.5_14B" if not is_vl else "QwenVL2.5_7B"
        super().__init__(model_name, is_vl, device, **kwargs)
        if not os.path.exists(self.model_name) and self.model_name in self.model_dict:
            self.model_name = self.model_dict[self.model_name]
        self.max_new_tokens = max_new_tokens
        self._model = None
        self._tok = None
        self._processor = None

    # -- lazy loading --------------------------------------------------------

    def _load_lm(self):
        if self._model is None:
            from transformers import AutoModelForCausalLM, AutoTokenizer

            self._model = AutoModelForCausalLM.from_pretrained(
                self.model_name, torch_dtype="auto")
            self._tok = AutoTokenizer.from_pretrained(self.model_name)

    def _load_vl(self):
        if self._model is None:
            from transformers import (AutoProcessor,
                                      Qwen2_5_VLForConditionalGeneration)

            self._processor = AutoProcessor.from_pretrained(
                self.model_name, min_pixels=256 * 28 * 28,
                max_pixels=1280 * 28 * 28, use_fast=True)
            self._model = Qwen2_5_VLForConditionalGeneration.from_pretrained(
                self.model_name, torch_dtype="auto")

    # -- extension -----------------------------------------------------------

    def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
        self._load_lm()
        _seed_torch(seed)
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        text = self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = self._tok([text], return_tensors="pt")
        out_ids = self._model.generate(
            **inputs, max_new_tokens=self.max_new_tokens)
        new_ids = out_ids[0][inputs["input_ids"].shape[1]:]
        expanded = self._tok.decode(new_ids, skip_special_tokens=True).strip()
        return PromptOutput(
            status=True, prompt=expanded, seed=seed,
            system_prompt=system_prompt,
            message=json.dumps({"content": expanded}, ensure_ascii=False))

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs):
        self._load_vl()
        _seed_torch(seed)
        if isinstance(image, str):
            from PIL import Image

            image = Image.open(image).convert("RGB")
        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": [
                {"type": "image", "image": image},
                {"type": "text", "text": prompt},
            ]},
        ]
        text = self._processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        inputs = self._processor(text=[text], images=[image],
                                 return_tensors="pt")
        out_ids = self._model.generate(
            **inputs, max_new_tokens=self.max_new_tokens)
        new_ids = out_ids[0][inputs["input_ids"].shape[1]:]
        expanded = self._processor.decode(
            new_ids, skip_special_tokens=True).strip()
        return PromptOutput(
            status=True, prompt=expanded, seed=seed,
            system_prompt=system_prompt,
            message=json.dumps({"content": expanded}, ensure_ascii=False))


class DashScopePromptExpander(PromptExpander):
    """Hosted-API variant (prompt_extend.py:157-298).  Needs the
    ``dashscope`` package and DASH_API_KEY; without the package construction
    raises a clear ImportError."""

    def __init__(self, api_key: Optional[str] = None,
                 model_name: Optional[str] = None, is_vl: bool = False,
                 retry_times: int = 4, **kwargs):
        if model_name is None:
            model_name = "qwen-plus" if not is_vl else "qwen-vl-max"
        super().__init__(model_name, is_vl, **kwargs)
        try:
            import dashscope
        except ImportError as e:
            raise ImportError(
                "DashScopePromptExpander requires the `dashscope` package "
                "and network access; use QwenPromptExpander with a local "
                "model instead") from e
        api_key = api_key or os.environ.get("DASH_API_KEY")
        if api_key:
            dashscope.api_key = api_key
        base_url = os.environ.get("DASH_API_URL")
        if base_url:
            dashscope.base_http_api_url = base_url
        self._dashscope = dashscope
        self.retry_times = retry_times

    def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
        from http import HTTPStatus

        messages = [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": prompt},
        ]
        exception = None
        for _ in range(self.retry_times):
            try:
                response = self._dashscope.Generation.call(
                    self.model_name, messages=messages, seed=seed,
                    result_format="message")
                if response.status_code == HTTPStatus.OK:
                    expanded = response.output.choices[0].message.content
                    return PromptOutput(
                        status=True, prompt=expanded, seed=seed,
                        system_prompt=system_prompt,
                        message=json.dumps(response, ensure_ascii=False))
                exception = RuntimeError(str(response))
            except Exception as e:  # noqa: BLE001 — retried API call
                exception = e
        return PromptOutput(status=False, prompt=prompt, seed=seed,
                            system_prompt=system_prompt,
                            message=str(exception))

    def extend_with_img(self, prompt, system_prompt, image=None, seed=-1,
                        *args, **kwargs):
        from http import HTTPStatus

        messages = [
            {"role": "system", "content": [{"text": system_prompt}]},
            {"role": "user", "content": [{"text": prompt},
                                         {"image": image}]},
        ]
        exception = None
        for _ in range(self.retry_times):
            try:
                response = self._dashscope.MultiModalConversation.call(
                    model=self.model_name, messages=messages, seed=seed,
                    result_format="message")
                if response.status_code == HTTPStatus.OK:
                    expanded = response.output.choices[0].message.content[0]["text"]
                    return PromptOutput(
                        status=True, prompt=expanded, seed=seed,
                        system_prompt=system_prompt,
                        message=json.dumps(response, ensure_ascii=False))
                exception = RuntimeError(str(response))
            except Exception as e:  # noqa: BLE001 — retried API call
                exception = e
        return PromptOutput(status=False, prompt=prompt, seed=seed,
                            system_prompt=system_prompt,
                            message=str(exception))


# ---------------------------------------------------------------------------
# lightweight functional interface (used by the CLIs)

PromptRewriter = Callable[[str], str]


def identity_rewriter(prompt: str) -> str:
    return prompt


def hf_rewriter(model_path: str, max_new_tokens: int = 256) -> PromptRewriter:
    """Rewriter from a local HF causal LM checkpoint (plain-completion
    variant kept for non-chat models)."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_path)
    model = AutoModelForCausalLM.from_pretrained(model_path)

    def rewrite(prompt: str) -> str:
        text = f"{LM_EN_SYS_PROMPT}\n\nPrompt: {prompt}\n\nExtended:"
        ids = tok(text, return_tensors="pt")
        out = model.generate(**ids, max_new_tokens=max_new_tokens, do_sample=False)
        return tok.decode(out[0][ids["input_ids"].shape[1]:],
                          skip_special_tokens=True).strip()

    return rewrite


def qwen_rewriter(model_path: str, tar_lang: str = "en",
                  max_new_tokens: int = 512) -> PromptRewriter:
    expander = QwenPromptExpander(model_path, max_new_tokens=max_new_tokens)

    def rewrite(prompt: str) -> str:
        out = expander(prompt, tar_lang=tar_lang)
        return out.prompt if out.status else prompt

    return rewrite


def get_rewriter(kind: str = "identity", **kwargs) -> PromptRewriter:
    if kind == "identity":
        return identity_rewriter
    if kind == "hf":
        return hf_rewriter(**kwargs)
    if kind == "qwen":
        return qwen_rewriter(**kwargs)
    raise ValueError(f"unknown prompt rewriter {kind!r}")
