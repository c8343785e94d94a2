"""Training checkpoints: save, restore, auto-resume.

A step's checkpoint is ``<logdir>/checkpoint_model_{step:06d}/`` (the
reference's naming) holding ``train_state.pt`` (``torch.save`` of the
trainer's ``state_dict()``: parameters, LoRA adapters where they train,
optimiser states, EMA, step; a streaming trainer's sequence state is not
saved, so a resumed run starts a new sequence) and
the loader's position ``loader_state_p{rank}.json``.  Only the newest
``max_checkpoints`` are kept.  Restoring reads tensors only
(``weights_only=True``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional

import torch

_STEP_RE = re.compile(r"checkpoint_model_(\d+)$")
_STATE = "train_state.pt"


def _ckpt_dir(logdir: str, step: int) -> str:
    return os.path.join(os.path.abspath(logdir), f"checkpoint_model_{step:06d}")


def list_checkpoint_steps(logdir: str) -> List[int]:
    """Steps with a complete checkpoint under ``logdir``."""
    if not os.path.isdir(logdir):
        return []
    out = []
    for name in os.listdir(logdir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(logdir, name, _STATE)):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint_step(logdir: str) -> Optional[int]:
    steps = list_checkpoint_steps(logdir)
    return steps[-1] if steps else None


def save_train_state(logdir: str, step: int, state: dict,
                     max_checkpoints: Optional[int] = None) -> str:
    """Writes ``state`` (a trainer's ``state_dict()``) for ``step``; the
    file appears whole or not at all.  Returns the checkpoint directory."""
    path = _ckpt_dir(logdir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_STATE}.tmp{os.getpid()}")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _STATE))
    if max_checkpoints:
        for s in list_checkpoint_steps(logdir)[:-max_checkpoints]:
            shutil.rmtree(_ckpt_dir(logdir, s), ignore_errors=True)
    return path


def restore_train_state(logdir: str, step: Optional[int] = None) -> Optional[Any]:
    """The saved ``state_dict()`` of ``step`` (default: the latest), its
    tensors on the CPU; None when there is no checkpoint."""
    if step is None:
        step = latest_checkpoint_step(logdir)
        if step is None:
            return None
    return torch.load(os.path.join(_ckpt_dir(logdir, step), _STATE), map_location="cpu",
                      weights_only=True)


def save_loader_state(logdir: str, step: int, state: dict, rank: int = 0) -> None:
    """The loader's position (``ShardedCheckpointableLoader.state()``),
    beside the step's checkpoint."""
    path = _ckpt_dir(logdir, step)
    os.makedirs(path, exist_ok=True)
    marker = os.path.join(path, f"loader_state_p{rank}.json")
    tmp = f"{marker}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, marker)


def load_loader_state(logdir: str, step: Optional[int] = None,
                      rank: int = 0) -> Optional[dict]:
    if step is None:
        step = latest_checkpoint_step(logdir)
        if step is None:
            return None
    marker = os.path.join(_ckpt_dir(logdir, step), f"loader_state_p{rank}.json")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return json.load(f)
