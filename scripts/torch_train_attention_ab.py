"""A/B of K4, the training flash attention, between two checkouts on one GPU.

Usage (from the repository root, on a host with an NVIDIA GPU):

    git archive <base commit> | tar -x -C build/base      # build/ is git-ignored
    python scripts/torch_train_attention_ab.py --base build/base \
        [--breakdown] [--train] [--out build/train_attention_ab.json]

This checkout's ``chip_smoke.py`` and ``scripts/torch_breakdown.py`` drive
each checkout's ``longlive_torch`` in turn (base, this tree, this tree,
base): the other checkout is used only through ``longlive_torch``'s entry
points, and builds its kernels under its own ``build/kernels``.  Every turn
times K4's forward, dQ and dK/dV kernels (CUDA events, 5 calls after a
warm-up) at the four shapes of ``chip_smoke.train_attention_cases`` on the
same inputs, and K2's sum over the 30 fused convs of one later latent frame
(``chip_smoke.conv_cases``: K2 shares ``csrc/sm90.cuh`` with K4).  Once per
shape it also times ``scaled_dot_product_attention`` forward and backward
(the library call; never used by the port) and computes the bounds
(``chip_smoke.train_attention_bounds``: valid kv tokens only).
``--breakdown`` profiles ``torch_breakdown.training_steps`` (the replay of
rollout block 6 with backward, the critic step) on each checkout, base
first; ``--train`` runs ``chip_smoke.run_training_path`` (``run_train``, 2
steps at full width; its launch counts are asserted) on each.  Prints one
JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7


def load_file(name: str, path: str):
    """The module in the file at ``path``, imported afresh as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def use_tree(root: str):
    """Makes the checkout at ``root``'s ``longlive_torch`` the loaded one
    (every submodule imported later comes from it too) and returns its
    (ops.attention, ops.vae_conv)."""
    for name in list(sys.modules):
        if name == "longlive_torch" or name.startswith("longlive_torch."):
            del sys.modules[name]
    sys.path.insert(0, root)
    try:
        A = importlib.import_module("longlive_torch.ops.attention")
        VC = importlib.import_module("longlive_torch.ops.vae_conv")
    finally:
        sys.path.remove(root)
    assert os.path.abspath(A.__file__).startswith(os.path.join(os.path.abspath(root), ""))
    return A, VC


def inputs(cases):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for label, sq, skv, valid in cases:
        q, dout = (torch.randn((1, sq, 12, 128), generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(2))
        k, v = (torch.randn((1, skv, 12, 128), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        out.append((label, q, k, v, dout, valid))
    return out


def time_k4(cs, A, data):
    rows = {}
    for label, q, k, v, dout, valid in data:
        o, lse = A.flash_attention_train_forward(q, k, v, valid)
        dq, delta = A.flash_attention_train_backward_dq(q, k, v, o, lse, dout, valid)
        torch.cuda.synchronize()
        rows[label] = {
            "fwd": cs.cuda_ms(torch, lambda: A.flash_attention_train_forward(q, k, v, valid), 5),
            "dq": cs.cuda_ms(torch, lambda: A.flash_attention_train_backward_dq(
                q, k, v, o, lse, dout, valid), 5),
            "dkdv": cs.cuda_ms(torch, lambda: A.flash_attention_train_backward_dkdv(
                q, k, v, o, lse, dout, delta, valid), 5),
        }
        del o, lse, dq, delta
    return rows


def library_and_bounds(cs, data):
    import torch.nn.functional as F

    rows = {}
    for label, q, k, v, dout, valid in data:
        b, sq, n, d = q.shape
        skv = k.shape[1]
        nvalid = skv if valid is None else int(valid.sum())
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask4 = None if valid is None else valid[:, None, None, :]
        lib_fwd = cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4), 5)
        lo = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4)
        lib_bwd = cs.cuda_ms(torch, lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), 5)
        rows[label] = {
            "q": [b, sq, n, d], "kv": [b, skv, n, d], "valid_tokens": nvalid,
            "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd,
            "bound_ms": dict(zip(("fwd", "dq", "dkdv"),
                                 cs.train_attention_bounds(b, sq, skv, n, d, nvalid))),
        }
        del qt, kt, vt, lo
    return rows


def k2_sum(cs, VC):
    with cs.switched(LONGLIVE_VAE_INT8="0"):
        _, tot = cs.conv_cases(torch, VC, False, "fused_causal_conv")
    return tot["ms"]


def breakdown():
    bd = load_file("torch_breakdown", os.path.join(ROOT, "scripts", "torch_breakdown.py"))
    with torch.enable_grad():
        steps = bd.training_steps(torch.device("cuda"))
    out = []
    for s in steps:
        k4 = s["groups_ms"].get("flash_attention_train (K4)", 0.0)
        out.append({"step": s["step"], "wall_ms": s["wall_ms"],
                    "device_busy_ms": s["device_busy_ms"], "idle_share": s["idle_share"],
                    "k4_ms": k4,
                    "k4_share_of_device": k4 / s["device_busy_ms"] if s["device_busy_ms"] else None,
                    "groups_ms": s["groups_ms"]})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--out", default="build/train_attention_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("error: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cs = load_file("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    trees = {"base": os.path.abspath(args.base), "this": ROOT}
    result = {"card": card, "torch": torch.__version__, "order": [], "k4": {}, "k2_sum_ms": {}}
    use_tree(ROOT)  # the cases' masks come from this checkout's kv cache
    data = inputs(cs.train_attention_cases(torch))
    result["shapes"] = library_and_bounds(cs, data)
    for turn, name in enumerate(("base", "this", "this", "base")):
        A, VC = use_tree(trees[name])
        key = f"{name}_{turn}"
        result["order"].append(key)
        result["k4"][key] = time_k4(cs, A, data)
        result["k2_sum_ms"][key] = k2_sum(cs, VC)
        print(json.dumps({key: result["k4"][key], "k2_sum_ms": result["k2_sum_ms"][key]}),
              flush=True)
    del data
    gc.collect()
    torch.cuda.empty_cache()
    if args.breakdown:
        result["breakdown"] = {}
        for name in ("base", "this"):
            use_tree(trees[name])
            result["breakdown"][name] = breakdown()
            print(json.dumps({"breakdown": name, "rows": result["breakdown"][name]}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    if args.train:
        result["train"] = {}
        for name in ("base", "this"):
            A, VC = use_tree(trees[name])
            result["train"][name] = cs.run_training_path(torch, A, VC, card)
            print(json.dumps({"train": name, "result": result["train"][name]}, default=str),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    text = json.dumps(result, indent=1, default=str)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text)


if __name__ == "__main__":
    main()
