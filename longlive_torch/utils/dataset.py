"""Prompt datasets: one prompt per line, and per-host sharding."""

from __future__ import annotations

from typing import List, Optional


class TextDataset:
    def __init__(self, prompt_path: str, extended_prompt_path: Optional[str] = None):
        with open(prompt_path, encoding="utf-8") as f:
            self.prompt_list = [line.rstrip() for line in f]
        self.extended_prompt_list = None
        if extended_prompt_path is not None:
            with open(extended_prompt_path, encoding="utf-8") as f:
                self.extended_prompt_list = [line.rstrip() for line in f]
            assert len(self.extended_prompt_list) == len(self.prompt_list)

    def __len__(self):
        return len(self.prompt_list)

    def __getitem__(self, idx):
        batch = {"prompts": self.prompt_list[idx], "idx": idx}
        if self.extended_prompt_list is not None:
            batch["extended_prompts"] = self.extended_prompt_list[idx]
        return batch


def shard(dataset, host_index: int, host_count: int) -> List:
    """Round-robin shard across hosts."""
    return [dataset[i] for i in range(host_index, len(dataset), host_count)]
