"""Tiny cells for the CPU tests: the harness's own configurations and
mixes at widths a CPU serves in seconds (the cells' files stay the
full-size ones)."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


TINY_WIDTHS = {
    "qwen3": {"hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16,
              "intermediate_size": 128, "num_hidden_layers": 2,
              "vocab_size": 256},
    "mixtral": {"hidden_size": 64, "num_attention_heads": 4,
                "num_key_value_heads": 2, "intermediate_size": 96,
                "num_hidden_layers": 2, "vocab_size": 256,
                "num_local_experts": 4},
}
TINY_ENGINE = {"max_batch": 8, "prefill_chunk": 32, "decode_chunk": 4,
               "block_tokens": 16, "n_blocks": 1024,
               "prefill_concurrency": 2}


# the limits of the numbers the cells compare, at these toy widths
TINY_LIMITS = {"logit_gap": 0.25, "logit_gap_mean": 0.05}


def tiny_spec(workload: str):
    """``workload``'s spec with its model cut to toy widths and its mix to
    toy lengths and rates; the metrics lists are the cell's own."""
    from portbench import core

    spec = core.cell_spec(workload)
    spec = copy.deepcopy(spec)
    conf = spec["config"]
    conf["config"].update(TINY_WIDTHS[conf["family"]])
    conf["engine"].update(TINY_ENGINE)
    mix = spec["mix"]
    if mix["loop"] == "open_sessions":
        mix.update({"session_rate": 3.0, "turns": [1, 3],
                    "tenants": {"system_tokens": [64, 40, 80, 24],
                                "zipf_s": 1.1},
                    "user_tokens": {"dist": "lognormal", "median": 16,
                                    "sigma": 0.5, "min": 4, "max": 40},
                    "answer_tokens": {"dist": "lognormal", "median": 8,
                                      "sigma": 0.4, "min": 4, "max": 16},
                    "think_s": [0.1, 0.3], "greedy_every": 2})
    else:
        mix.update({"clients": 6, "min_request_s": 0.02,
                    "prompt_tokens": {"dist": "uniform", "min": 8,
                                      "max": 40},
                    "answer_tokens": {"dist": "uniform", "min": 4,
                                      "max": 12}, "greedy_every": 2})
    mix["harness"] = {"warmup_s": 1.0, "drain_s": 30.0, "trace_s": 1.0}
    spec["limits"] = {"compare": {k: TINY_LIMITS[k]
                                  for k in spec["limits"]["compare"]},
                      "check_tokens": 48,
                      "min_checked_tokens": 16}
    return spec
