"""A copy of the benchmark at a tiny size, for the CPU tests: the
package's files, tiny configurations beside the shipped ones, and a
BENCHMARK.json whose cells run them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent

DIT = {"dim": 64, "ffn_dim": 128, "num_heads": 4, "num_layers": 2, "in_dim": 4, "out_dim": 4,
       "text_dim": 32, "text_len": 16, "freq_dim": 32, "patch_size": [1, 2, 2], "eps": 1e-06,
       "qk_norm": True, "cross_attn_norm": True, "rope_max_pos": 1024, "dtype": "float32"}
CAUSAL = dict(DIT, name="tiny-causal", model_type="causal", height=16, width=16,
              vae_stride=[2, 2, 2],
              vae={"dim": 8, "z_dim": 4, "dim_mult": [1, 2], "num_res_blocks": 1,
                   "temperal_downsample": [True]},
              local_attn_size=9, sink_size=3, num_frame_per_block=3,
              denoising_step_list=[1000, 750, 500, 250], warp_denoising_step=True,
              timestep_shift=5.0, context_noise=0, num_output_frames=300)
T2V = dict(DIT, name="tiny-t2v", model_type="t2v", height=32, width=32, frame_num=9,
           vae_stride=[4, 4, 4], sample_steps=6, sample_shift=5.0, sample_guide_scale=5.0,
           sample_solver="unipc")
SAMPLER_NUMBERS = ["attn_err", "cross_err", "ffn_err", "head_err"]
SERVE_NUMBERS = SAMPLER_NUMBERS + ["kv_err", "vae_err"]


def make_root(tmp: Path, limits: float = 1e-3) -> Path:
    """``tmp`` holding the benchmark package and a BENCHMARK.json with the
    tiny cells stream, steer, t2v (their limits ``limits``)."""
    shutil.copytree(HERE, tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "longlive_torch").symlink_to(ROOT / "longlive_torch")  # the program, as in a checkout
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {}
    for cfg in (CAUSAL, T2V):
        f = tmp / "benchmark" / "configs" / f"{cfg['name']}.json"
        f.write_text(json.dumps(cfg))
        files[cfg["name"]] = f"benchmark/configs/{cfg['name']}.json"
    bench["configs"] = [{"name": n, "source": "tiny", "file": f, "reduced": [], "why": "tiny"}
                        for n, f in files.items()]
    cfg_of = {"stream": "tiny-causal", "steer": "tiny-causal", "t2v": "tiny-t2v"}
    for w in bench["workloads"]:
        w["config"] = cfg_of.get(w["name"], w["config"])
        lim = {"stream": SERVE_NUMBERS, "steer": SERVE_NUMBERS,
               "t2v": SAMPLER_NUMBERS}.get(w["name"], [])
        (tmp / "benchmark" / "limits" / f"{w['name']}.json").write_text(
            json.dumps({"limits": {n: limits for n in lim}}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, workload: str, seed: int = 12345678901, seconds: float = 1.0,
        trace: int = 0, variant: str = "program", capsys=None):
    """One tiny run through ``benchmark.run.main`` on the CPU; its result
    line as a dict."""
    import contextlib
    import io

    from benchmark import run as R

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace), "--variant", variant],
                    root=root, require_chip=False, device="cpu")
    assert rc == 0, rc
    return json.loads(buf.getvalue().strip().splitlines()[-1])
