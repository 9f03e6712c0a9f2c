"""A Mixtral-shaped configuration small enough for the CPU, and a cell of
it, written beside a test's temporary files."""
from __future__ import annotations

import json
import time
from pathlib import Path

from perfbench import manifest

ROOT = manifest.ROOT

TINY = {
    "source": "https://huggingface.co/mistralai/Mixtral-8x7B-v0.1",
    "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 256,
    "max_position_embeddings": 512, "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-05, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "system": "collaborative_engine",
    "reference": "moe_lm",
    "cache": {"num_indexes": 1, "num_ways": 2, "policy": "lru"},
    "engine": {"prefill_chunk": 8, "admit_chunks_per_tick": 0,
               "prefetch": False, "host_compute": False, "kv_paged": False},
    "prefill_dispatch": {"capacity_factor": 1.25,
                         "serve_capacity_factor": 8.0,
                         "slack_max_assignments": 256, "round_to": 8},
    "limits": {"far": 6.0},
}

MIX = {"arrival": "closed", "clients": 2,
       "prompt_tokens": {"lo": 8, "hi": 24}, "new_tokens": {"lo": 6, "hi": 6},
       "block": 4, "capacity": 31, "greedy": True}


def cell(tmp: Path, cfg=None, mix=None, name="tiny") -> manifest.Cell:
    """A cell of the tiny configuration under the tiny mix (or the ones
    given), its files in ``tmp``."""
    c, m = tmp / f"{name}.json", tmp / f"{name}_mix.json"
    c.write_text(json.dumps(dict(TINY, **(cfg or {}))))
    m.write_text(json.dumps(dict(MIX, **(mix or {}))))
    bench = manifest.load()
    return manifest.Cell(
        name=f"{name}.{name}_mix", config=name, traffic=f"{name}_mix",
        chips=1, config_file=c, traffic_file=m,
        end_to_end=[x["name"] for x in bench["end_to_end"]],
        per_layer=[x["name"] for x in bench["per_layer"]])


class StepClock:
    """A clock that moves 1 ms at each reading, so that the window closes
    after the same work on every machine, however loaded: a time window
    on a busy host held as few as 17 served tokens, too few for the
    check's shares to settle."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1e-3
        return self.t

    perf_counter_ns = staticmethod(time.perf_counter_ns)
