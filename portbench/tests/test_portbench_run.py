"""Whole runs of both cells on the CPU at toy widths: the harness past its
look for a card, the served path, the metrics and the check.  A sound run
comes out correct; with a served token altered where the engine produces
it, the check comes out not correct."""

import pytest

from portbench import core
from tiny import tiny_spec

CELLS = ["qwen3-8b.chat-shared-prefix", "mixtral-8x7b.batch-decode"]
SEED = 2 ** 33 + 17


def _alter_tokens(server):
    """Fault: every decode dispatch's last token of each row comes out one
    id higher than the engine chose."""
    eng = server.engine
    decode_batch, V = eng.decode_batch, eng.cfg.vocab_size

    def altered(states, n_steps, *a, **kw):
        outs = decode_batch(states, n_steps, *a, **kw)
        for row in outs:
            row[-1] = (row[-1] + 1) % V
        return outs

    eng.decode_batch = altered


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    spec = tiny_spec(cell)
    out = core.run_cell(cell, SEED, 2.5, False, device="cpu", spec=spec)
    res = out["result"]
    assert res["correct"], res["checked"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "checked"


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_is_not_correct(cell):
    out = core.run_cell(cell, SEED, 2.5, False, device="cpu",
                        spec=tiny_spec(cell), fault=_alter_tokens)
    assert not out["result"]["correct"], out["result"]["checked"]


def test_traced_run_reports_the_host_layers():
    cell = CELLS[0]
    out = core.run_cell(cell, SEED + 1, 2.5, True, device="cpu",
                        spec=tiny_spec(cell))
    m = out["result"]["metrics"]
    for name in ("prefix_hit_share", "decode_step_ms"):
        assert name in m, m
    assert 0 < m["prefix_hit_share"]["value"] < 100
    # no card: no device time, so nothing is read off the device
    assert "k1_roofline" not in m and "mfu.serve" not in m
