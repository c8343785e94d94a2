"""Prompt datasets: one prompt per line, prompt pairs (switch training),
prompt lists per line (interactive mode), per-host sharding, and the
checkpointable training loader."""

from __future__ import annotations

import json
import random
from typing import Iterator, List, Optional, Sequence


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


class TwoTextDataset:
    """Prompt pairs: the first segment's prompt and the post-switch prompt."""

    def __init__(self, prompt_path: str, switch_prompt_path: str):
        with open(prompt_path, encoding="utf-8") as f:
            self.first = [line.rstrip() for line in f]
        with open(switch_prompt_path, encoding="utf-8") as f:
            self.second = [line.rstrip() for line in f]
        if len(self.first) != len(self.second):
            raise ValueError(f"{prompt_path} has {len(self.first)} prompts, "
                             f"{switch_prompt_path} {len(self.second)}")

    def __len__(self):
        return len(self.first)

    def __getitem__(self, idx):
        return {"prompts": self.first[idx], "switch_prompts": self.second[idx], "idx": idx}


class MultiTextDataset:
    """JSONL with {"prompts": [p0, p1, ...]} per line (interactive mode)."""

    def __init__(self, jsonl_path: str):
        self.rows: List[List[str]] = []
        with open(jsonl_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    self.rows.append(json.loads(line)["prompts"])

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        return {"prompts": self.rows[idx], "idx": idx}


def shard(dataset, host_index: int, host_count: int) -> List:
    """Round-robin shard across hosts."""
    return [dataset[i] for i in range(host_index, len(dataset), host_count)]


def shuffled_indices(n: int, seed: int, epoch: int) -> List[int]:
    """The epoch's permutation, the same on every host for (seed, epoch)
    (and the same as the JAX package's: Python's ``random`` with the same
    seed)."""
    idx = list(range(n))
    random.Random((seed << 20) ^ epoch).shuffle(idx)
    return idx


def epoch_shard(dataset, host_index: int, host_count: int, seed: int, epoch: int) -> List:
    """Shuffled, then sharded: this host's rows of one epoch."""
    order = shuffled_indices(len(dataset), seed, epoch)
    return [dataset[i] for i in order[host_index::host_count]]


def cycle(iterable: Sequence) -> Iterator:
    while True:
        for item in iterable:
            yield item


class ShardedCheckpointableLoader:
    """Per-host sharded, per-epoch shuffled prompt loader whose position
    can be saved and restored: ``state()`` is (epoch, index in this host's
    shard), and a loader built with it continues mid-epoch with no sample
    repeated or skipped."""

    def __init__(self, dataset, host_index: int = 0, host_count: int = 1, seed: int = 0,
                 state: Optional[dict] = None):
        if not 0 <= host_index < host_count:
            raise ValueError(f"host {host_index} of {host_count}")
        self.ds = dataset
        self.host_index = host_index
        self.host_count = host_count
        self.seed = seed
        self.epoch = int(state["epoch"]) if state else 0
        self.index = int(state["index"]) if state else 0
        self._order_epoch = -1
        self._order: List[int] = []

    def _shard_order(self) -> List[int]:
        if self._order_epoch != self.epoch:
            order = shuffled_indices(len(self.ds), self.seed, self.epoch)
            self._order = order[self.host_index::self.host_count]
            self._order_epoch = self.epoch
        return self._order

    def __iter__(self):
        return self

    def __next__(self):
        order = self._shard_order()
        if self.index >= len(order):
            self.epoch += 1
            self.index = 0
            order = self._shard_order()
        row = self.ds[order[self.index]]
        self.index += 1
        return row

    def state(self) -> dict:
        """The position after the last row handed out."""
        return {"epoch": self.epoch, "index": self.index}
