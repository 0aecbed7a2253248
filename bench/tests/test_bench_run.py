"""The harness end to end on the CPU at tiny sizes: the result line, a run
without a card, and a configuration, traffic mix and per-layer metric
added as new files only."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_reports_the_cells_metrics(root, cell, trace):
    from bench.manifest import Manifest

    r = tiny.run(root, cell, trace=trace)
    man = Manifest(root)
    c = man.cell(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(man.limits(c))
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in man.end_to_end(c)}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert set(r["metrics"]) <= {m["name"] for m in man.per_layer(c)}
        assert r["metrics"], "no per-layer metric was read"
        assert "busy_s" in r["device"] and "window_s" in r["device"]
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["platform"] == "cpu"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", tiny.TRAIN,
         "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "memory_peak_bytes" not in out.stderr


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_add_a_configuration_a_mix_and_a_metric(tmp_path):
    """A cell of another configuration and traffic mix, with a per-layer
    metric of its own, from new files and new entries alone."""
    root = tiny.tiny_root(tmp_path)
    before = _digests(root / "bench")
    b = root / "bench"
    cfg = json.loads((b / "configs" / "minicpm-2b.json").read_text())
    cfg.update(num_layers=3, d_model=96, num_heads=6, num_kv_heads=2)
    (b / "configs" / "tiny-gqa.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "serve-longprompt.json").read_text())
    mix.update(clients=3, slots=2, prompt_len=[8, 20], output_len=[3, 5])
    (b / "traffic" / "short-chat.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny-gqa.short-chat.json").write_text(
        json.dumps({"limits": {"logit_gap_mean": 0.006}}))
    (b / "metrics" / "prefills.chat.py").write_text(
        "def read(rec):\n"
        "    return float(sum(s.name == 'prefill' for s in rec.spans))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-gqa", "source": "test",
                                "file": "bench/configs/tiny-gqa.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny-gqa.short-chat",
                                  "config": "tiny-gqa",
                                  "traffic": "short-chat", "chips": 1,
                                  "why": "test"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and "serve" in m["name"]:
            m["workloads"].append("tiny-gqa.short-chat")
    manifest["per_layer"].append({
        "name": "prefills.chat", "unit": "count", "better": "higher",
        "source": "program_span", "layer": "serving engine",
        "moves": "serve_tokens_per_s", "workloads": ["tiny-gqa.short-chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    plain = tiny.run(root, "tiny-gqa.short-chat")
    assert plain["correct"] and "serve_tokens_per_s" in plain["metrics"]
    traced = tiny.run(root, "tiny-gqa.short-chat", trace=True)
    assert traced["correct"] and traced["metrics"]["prefills.chat"][
        "value"] > 0
    after = _digests(root / "bench")
    assert {k: after[k] for k in before} == before


SLIDING = '''"""Mixer kind ``sliding``: ``full``'s attention, each query attending its
``sliding_window`` latest positions."""

import math

import torch

from bench.reference import transformer as R
from bench.reference.mixer import full

leaves = full.leaves
attention_per_context = full.attention_per_context


def branch(x, w, p, cfg, pr, routed=None):
    x = R.rmsnorm(x, w[f"{p}.ln1.scale"], cfg["norm_eps"])
    m, (s, d) = f"{p}.mixer", x.shape
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = w[f"{m}.wq"].shape[-1]
    pos = torch.arange(s, device=x.device)

    def proj(name, h):
        return pr.mm(x, w[f"{m}.{name}"].reshape(d, h * hd)).view(s, h, hd)

    q = R.rope(proj("wq", hq), pos, cfg["rope_theta"]).transpose(0, 1)
    k = R.rope(proj("wk", hkv), pos, cfg["rope_theta"]) \\
        .repeat_interleave(hq // hkv, 1).transpose(0, 1)
    v = proj("wv", hkv).repeat_interleave(hq // hkv, 1).transpose(0, 1)
    sc = pr.einsum("hqd,hkd->hqk", q, k) / math.sqrt(hd)
    qi, ki = pos[:, None], pos[None, :]
    sc = sc.masked_fill((ki > qi) | (ki <= qi - WINDOW), float("-inf"))
    o = pr.einsum("hqk,hkd->hqd", torch.softmax(sc, -1), v)
    return pr.mm(o.transpose(0, 1).reshape(s, hq * hd),
                 w[f"{m}.wo"].reshape(hq * hd, d)), None
'''


@pytest.mark.parametrize("window,correct", [("cfg['sliding_window']", True),
                                            ("cfg['sliding_window'] // 2",
                                             False)])
def test_a_new_file_adds_a_mixer_kind(tmp_path, window, correct):
    """A configuration whose layers alternate a new mixer kind, sliding
    attention, with full attention: the kind's plan and reference are one
    new file, the port runs its own sliding layers, and the reference's
    kind is what decides (half its window reads not correct)."""
    root = tiny.tiny_root(tmp_path)
    before = _digests(root / "bench")
    b = root / "bench"
    (b / "reference" / "mixer" / "sliding.py").write_text(
        SLIDING.replace("WINDOW", window))
    cfg = json.loads((b / "configs" / "minicpm-2b.json").read_text())
    cfg.update(unit=[["sliding", "dense"], ["full", "dense"]],
               sliding_window=16)
    (b / "configs" / "tiny-sliding.json").write_text(json.dumps(cfg))
    (b / "limits" / "tiny-sliding.train-4k.json").write_text(json.dumps(
        {"limits": tiny.LIMITS[tiny.TRAIN]}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny-sliding", "source": "test",
                                "file": "bench/configs/tiny-sliding.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny-sliding.train-4k",
                                  "config": "tiny-sliding",
                                  "traffic": "train-4k", "chips": 1,
                                  "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-sliding.train-4k")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    r = tiny.run(root, "tiny-sliding.train-4k")
    assert r["correct"] is correct, r["checks"]
    assert r["metrics"]["train_tokens_per_s"]["value"] > 0
    after = _digests(root / "bench")
    assert {k: after[k] for k in before} == before
