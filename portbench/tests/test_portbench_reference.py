"""The plain references against the port's plain CPU forward on tiny
configurations of each family, with the same float32 weights."""

import pytest
import torch

from portbench.families import common
from tiny import TINY_WIDTHS


def _setup(family):
    import importlib

    from portbench.core import load_json

    fam = importlib.import_module("portbench.families." + family)
    ref = importlib.import_module("portbench.reference." + family)
    name = {"qwen3": "qwen3-8b", "mixtral": "mixtral-8x7b"}[family]
    cfg = {**load_json(common.__file__.rsplit("/families", 1)[0],
                       "configs", name + ".json")["config"],
           **TINY_WIDTHS[family]}
    params = fam.draw(cfg, 1234, "cpu")
    # float32 weights on both sides: the comparison is of the arithmetic
    flat = {k: v.float() for k, v in common.flatten(params).items()}
    params = common.nest(flat)
    return fam, ref, cfg, params


@pytest.mark.parametrize("family", ["qwen3", "mixtral"])
def test_reference_matches_the_port_plain_forward(family):
    import dataclasses

    fam, ref, cfg, params = _setup(family)
    port_cfg = dataclasses.replace(fam.port_config(cfg), dtype=torch.float32)
    fwd = fam.engine_kwargs().get("prefill_fn")
    if fwd is None:
        from infinistore_tpu_torch.models.llama import prefill_forward as fwd
    toks = torch.randint(0, cfg["vocab_size"], (1, 37),
                         generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got, _ = fwd(params, port_cfg, toks)
    rows = list(range(37))
    want = ref.logits_at(params, cfg, toks[0].tolist(), rows)
    torch.testing.assert_close(got[0].float(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["qwen3", "mixtral"])
def test_fp8_control_departs_from_the_reference(family):
    _, ref, cfg, params = _setup(family)
    toks = list(range(3, 40))
    want = ref.logits_at(params, cfg, toks, list(range(37)))
    low = ref.logits_at(params, cfg, toks, list(range(37)), fp8=True)
    err = (low - want).abs().max().item()
    assert 1e-3 < err < 0.5 * want.abs().max().item()
