"""A copy of the benchmark whose cells run the port's tiny-test model on
the CPU, through the same harness, drivers and readers, with a cell for
each traffic mix that BENCHMARK.json has no cell of yet."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import core

TINY = {
    "name": "tiny-test", "source": "tiny-test preset of the port",
    "preset": "tiny-test", "model_type": "qwen2", "vocab_size": 512,
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "hidden_act": "silu", "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 128, "tie_word_embeddings": False,
    "attention_bias": True, "torch_dtype": "float32", "port": {},
    "reduced": [],
}

# each traffic file's sizes cut to what the tiny model holds
SMALL = {
    "group_decode": {"system_tokens": 12,
                     "prompt_tokens": [4, 12, "log_uniform"],
                     "completion_tokens": [4, 24, "log_uniform"],
                     "group_size": 4, "strata": 8, "num_slots": 8,
                     "max_len": 96, "step_tokens": 32, "min_queue": 2,
                     "warmup_steps": 4},
    "agent_sessions": {"system_tokens": 24, "task_tokens": [8, 16, "uniform"],
                       "reply_tokens": [2, 8, "log_uniform"],
                       "tool_tokens": [4, 12, "uniform"],
                       "turns": [1, 6, "uniform"],
                       "max_prompt": 100, "sessions": 4, "num_slots": 4,
                       "max_len": 112, "step_tokens": 48,
                       "warmup_steps": 4},
    "grpo_train": {"system_tokens": 6, "prompt_tokens": [2, 10, "uniform"],
                   "completion_tokens": [4, 16, "log_uniform"],
                   "accum_steps": 2},
}


# cells that BENCHMARK.json does not hold yet, whose drivers the tests
# still run: (traffic, configuration, end-to-end metrics, per-layer
# metrics); a metric BENCHMARK.json lacks takes its entry from NEW_METRICS
EXTRA = {
    "tiny.agent_sessions": ("agent_sessions", "deepseek-coder-6.7b",
                            ["rollout_tok_s", "ttft_p95_ms", "setup_s"],
                            ["prefill_tokens_per_call.agent", "mfu.rollout",
                             "idle_share.rollout"]),
}
NEW_METRICS = {
    "ttft_p95_ms": {"name": "ttft_p95_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock"},
    "prefill_tokens_per_call.agent": {
        "name": "prefill_tokens_per_call.agent", "unit": "tokens",
        "better": "lower", "source": "program_counter",
        "layer": "engine prefix plane (rollout/engine.py)",
        "moves": "ttft_p95_ms"},
}


def _add_extra(spec: dict) -> None:
    for cell, (tr, cfg, e2e, per_layer) in EXTRA.items():
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": tr, "chips": 1, "why": "test"})
        for group, names in (("end_to_end", e2e), ("per_layer", per_layer)):
            have = {m["name"]: m for m in spec[group]}
            for name in names:
                m = have.get(name)
                if m is None:
                    m = dict(NEW_METRICS[name], workloads=[])
                    spec[group].append(m)
                if "workloads" in m:
                    m["workloads"].append(cell)


def make_root(tmp, *, port=None, limits=None) -> str:
    """A benchmark tree under ``tmp`` whose configurations all name the
    tiny model, with the traffic files cut to size. Returns its root."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(core.BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(core.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        cfg = dict(TINY, name=c["name"], port=dict(port or {}))
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(root, "benchmark", "traffic")
    for name, small in SMALL.items():
        path = os.path.join(tdir, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                t = json.load(f)
            t.update(small)
            with open(path, "w") as f:
                json.dump(t, f)
    _add_extra(spec)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    for cell, lim in (limits or {}).items():
        with open(os.path.join(root, "benchmark", "limits",
                               f"{cell}.json"), "w") as f:
            json.dump({"checks": lim}, f)
    return root
