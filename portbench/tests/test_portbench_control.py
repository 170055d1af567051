"""The control on the card: the reference in float8 in the program's
place reads a logit gap far above what the program's bf16 tokens read, at
full widths and a few layers, on three seeds."""

import pytest
import torch

from portbench import check
from portbench.core import Run, cell_spec

LAYERS = 4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["qwen3-8b.chat-shared-prefix",
                                  "mixtral-8x7b.batch-decode"])
def test_fp8_control_reads_over_the_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at full widths")
    import importlib

    spec = cell_spec(cell)
    cfg = {**spec["config"]["config"], "num_hidden_layers": LAYERS}
    spec["config"] = {**spec["config"], "config": cfg}
    fam = importlib.import_module("portbench.families."
                                  + spec["config"]["family"])
    ref = importlib.import_module("portbench.reference."
                                  + spec["config"]["family"])
    for seed in (1, 2, 3):
        params = fam.draw(cfg, seed, "cuda")
        prompt = torch.randint(0, cfg["vocab_size"], (512,),
                               generator=torch.Generator().manual_seed(seed))
        # greedy answers of the reference itself: gap 0 by construction
        out = []
        toks = prompt.tolist()
        for _ in range(16):
            nxt = ref.logits_at(params, cfg, toks, [len(toks) - 1])
            toks.append(int(nxt.argmax()))
            out.append(toks[-1])
        row = {"greedy": True, "ok": True, "prompt_len": 512, "n_tokens": 16,
               "trace_id": "t", "prompt": prompt.tolist(), "output": out,
               "due": 0.0}
        g = check.gaps(Run(rows=[row], t_open=0.0, t_close=1.0), params, spec, seed,
                       fp8=True)
        for name, limit in spec["limits"]["compare"].items():
            assert g["program"][name] == 0.0
            assert g["control"][name] > limit, g
