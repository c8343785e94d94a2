"""Single-switch generation: one prompt switch at a fixed frame, the special
case of the interactive pipeline with two segments."""

from __future__ import annotations

from typing import Optional

import torch

from ..models import dit as D
from .interactive import InteractiveCausalInferencePipeline


class SwitchCausalInferencePipeline(InteractiveCausalInferencePipeline):
    def generate_latents_switch(
        self, noise: torch.Tensor, cross_first: D.CrossKV, cross_second: D.CrossKV,
        switch_frame_index: int, generator: Optional[torch.Generator] = None,
        profile: bool = False,
    ) -> torch.Tensor:
        return self.generate_latents_interactive(
            noise, [cross_first, cross_second], [switch_frame_index],
            generator=generator, profile=profile)
