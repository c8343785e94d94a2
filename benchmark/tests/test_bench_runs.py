"""Whole runs of the harness at a tiny size on the CPU (its look for a
chip skipped): sound runs come out correct, and each fault a cell can have,
planted in the program underneath, and the int8 control come out not
correct."""

import json

import pytest
import torch

from benchmark.tests import tiny

# float32 program against the float32 reference reads ~1e-6 here (the t2v
# sampler conditions its prompts in bf16: ~3e-3); the int8 control ~7e-3
# and up, the faults 1e-1 and up
TINY_LIMIT = 1e-3
T2V_LIMIT = 6e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.make_root(tmp_path_factory.mktemp("bench"), TINY_LIMIT)
    lim = r / "benchmark" / "limits" / "t2v.json"
    lim.write_text(json.dumps({"limits": {n: T2V_LIMIT for n in tiny.SAMPLER_NUMBERS}}))
    return r


@pytest.mark.parametrize("workload", ["stream", "steer", "t2v"])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, workload, trace):
    d = tiny.run(root, workload, seed=2**31 + 17, seconds=0.5, trace=trace)
    assert d["correct"], d["checks"]
    assert set(d) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(json.loads(json.dumps(d)))[-1] == "checks"
    if trace:
        assert {"busy_s", "window_s"} <= set(d["device"]) and "breakdown" in d
    else:
        assert "setup_s" in d["metrics"]


def _state_unchanged(monkeypatch):
    from longlive_torch.pipeline.causal_inference import CausalInferencePipeline

    def block_step(self, cache, cross_kv, noise_block, start_frame, generator, skip_commit=False):
        return noise_block, cache  # the step returns its input

    monkeypatch.setattr(CausalInferencePipeline, "_block_step", block_step)


def _latent_altered(monkeypatch):
    from longlive_torch.pipeline.causal_inference import CausalInferencePipeline

    orig = CausalInferencePipeline.generate_latents_scanned

    def gen(self, *a, **kw):
        lat, cache = orig(self, *a, **kw)
        lat = lat.clone()
        lat[:, 1, 0] += 0.5  # one channel of one frame, where it is produced
        return lat, cache

    monkeypatch.setattr(CausalInferencePipeline, "generate_latents_scanned", gen)


def _pixels_altered(monkeypatch):
    from longlive_torch.models import vae as V

    orig = V.vae_decode_scan

    def dec(*a, **kw):
        px, caches = orig(*a, **kw)
        return torch.flip(px, dims=[-1]), caches  # the frame mirrored

    monkeypatch.setattr(V, "vae_decode_scan", dec)


def _solver_unchanged(monkeypatch):
    from longlive_torch.ops import solvers as SV

    def sample_flow(model_fn, noise, coeffs):
        x = noise
        for t in coeffs.timesteps:
            model_fn(x, float(t))  # the state never moves
        return x

    monkeypatch.setattr(SV, "sample_flow", sample_flow)


def _half_batch(monkeypatch):
    from longlive_torch.models.dit import CrossKV
    from longlive_torch.pipeline import text2video as T

    orig = T.bidirectional_forward

    def fwd(params, cfg, tables, x, t, cross, **kw):
        h = x.shape[0] // 2  # the uncond half left out: the cond half stands for both
        out = orig(params, cfg, tables, x[:h], t[:h], CrossKV(cross.k[:, :h], cross.v[:, :h]),
                   **kw)
        return torch.cat([out, out])

    monkeypatch.setattr(T, "bidirectional_forward", fwd)


def _flow_altered(monkeypatch):
    from longlive_torch.pipeline import text2video as T

    orig = T.guided_sampler

    def guided(*a, **kw):
        fn = orig(*a, **kw)
        return lambda x, t: fn(x, t) * 1.05

    monkeypatch.setattr(T, "guided_sampler", guided)


def _ffn_weight_off(monkeypatch):
    from longlive_torch.models import nn

    orig = nn.linear

    def linear(x, p):
        y = orig(x, p)
        w = p.get("weight")
        if w is not None and tuple(w.shape) == (128, 64):  # the FFN's fc1 at the tiny size
            return y * 1.01
        return y

    monkeypatch.setattr(nn, "linear", linear)


def _head_modulation_swapped(monkeypatch):
    from longlive_torch.models import dit as D
    from longlive_torch.models import dit_bidirectional as DB
    from longlive_torch.models import nn

    def head(params, cfg, x, e, f):
        hp = params["head"]
        em = hp["modulation"][None, None].to(e.dtype) + e[:, :, None]
        h = D._modulated(x, cfg, f, em[:, :, 1][:, :, None], em[:, :, 0][:, :, None])
        return nn.linear(h, hp["head"])  # shift and scale swapped

    def bidi_head(head_p, cfg, tokens, e, shape):
        b, f, c, h, w = shape
        em = head_p["modulation"][None].to(e.dtype) + e[:, None]
        y = nn.layer_norm(tokens, cfg.eps) * (1 + em[:, 0][:, None]) + em[:, 1][:, None]
        return D.unpatchify(nn.linear(y, head_p["head"]).float(), cfg, f, h, w)

    monkeypatch.setattr(D, "_head", head)
    monkeypatch.setattr(DB, "_bidi_head", bidi_head)


def _cross_output_scaled(monkeypatch):
    from longlive_torch.models import dit as D
    from longlive_torch.models import dit_bidirectional as DB

    cross0, attend0 = D._cross_attention_layer, DB._attend

    def cross(layer_p, cfg, x, ck, cv, train=False):
        return cross0(layer_p, cfg, x, ck, cv * 1.01, train)  # V as the layer reads it

    def attend(q, k, v, attn_impl, cross):
        out = attend0(q, k, v, attn_impl, cross)
        return out * 1.01 if cross else out

    monkeypatch.setattr(D, "_cross_attention_layer", cross)
    monkeypatch.setattr(DB, "_attend", attend)


def _condition_altered(monkeypatch):
    from longlive_torch.models import dit as D
    from longlive_torch.pipeline import text2video as T

    orig = T.prepare_condition

    def prepare(*a, **kw):
        ckv = orig(*a, **kw)
        return D.CrossKV(k=ckv.k, v=ckv.v * 1.01)  # the prompt's V, where it is made

    monkeypatch.setattr(T, "prepare_condition", prepare)


FAULTS = {
    "stream": [_state_unchanged, _latent_altered, _pixels_altered, _ffn_weight_off,
               _head_modulation_swapped, _cross_output_scaled],
    "steer": [_state_unchanged, _latent_altered, _pixels_altered, _ffn_weight_off,
              _head_modulation_swapped, _cross_output_scaled],
    "t2v": [_solver_unchanged, _half_batch, _flow_altered, _ffn_weight_off,
            _head_modulation_swapped, _cross_output_scaled, _condition_altered],
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_fault_comes_out_not_correct(root, monkeypatch, workload, fault):
    fault(monkeypatch)
    d = tiny.run(root, workload, seed=2**31 + 17, seconds=0.5)
    assert not d["correct"], d["checks"]


@pytest.mark.parametrize("workload,variant", [("stream", "int8"), ("steer", "int8"),
                                              ("t2v", "fp8ref")])
def test_control_comes_out_not_correct(root, workload, variant):
    d = tiny.run(root, workload, seed=2**31 + 17, seconds=0.5, variant=variant)
    assert not d["correct"], d["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload,variant", [("stream", "int8"), ("steer", "int8"),
                                              ("t2v", "fp8ref")])
def test_control_fails_at_the_cells_size(card, workload, variant):
    """The control at the cell's own size on the card, on three seeds: the
    program's int8 serving path in place of its bf16 one, or for the sampler
    (which has no such path) the plain reference with float8 operands in the
    program's place.  Every run comes out not correct."""
    import subprocess
    import sys

    for seed in (9001, 9002000003, 2147483711):
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                              "--seed", str(seed), "--seconds", "8", "--variant", variant],
                             cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        d = json.loads(out.stdout.strip().splitlines()[-1])
        assert not d["correct"], d["checks"]
