"""launch/prefill_spans.py: its span names match the paged prefill
kernel's marks, and its report divides the counters as it says.  The
spans themselves are read only on the card."""

import re
from pathlib import Path

import pytest

from repro_torch.launch import prefill_spans

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "pasa_paged_prefill.cuh")


def test_every_mark_has_a_name_and_every_name_a_mark():
    text = HEADER.read_text()
    marks = {(int(w), int(k)) for w, k in
             re.findall(r"PASA_SPAN\((\d), (\d+)\);", text)}
    names = {(who, k) for who, spans in enumerate(prefill_spans.SPANS.values())
             for k in range(len(spans))}
    assert marks == names
    tallies = set(re.findall(r"PASA_TALLY\((\d), (\d+)\);", text))
    assert tallies == {("0", "14"), ("0", "15"), ("1", "14"), ("1", "15")}


def test_report_shares_and_rates():
    conv = [30, 10, 0, 50, 10] + [0] * 9 + [2, 16]
    cons = [5, 10, 15, 20, 5, 25, 10, 5, 5] + [0] * 5 + [4, 32]
    rep = prefill_spans.report(conv + cons)
    assert rep["converter"]["stages"] == 2
    assert rep["consumer"]["pages"] == 32
    for thread in ("converter", "consumer"):
        shares = [v["share"] for v in rep[thread].values()
                  if isinstance(v, dict)]
        assert sum(shares) == pytest.approx(1.0)
    assert rep["converter"]["K' and V"]["per_stage"] == 25.0
    assert rep["consumer"]["the fold"]["per_page"] == 5 / 32
    assert rep["consumer"]["the rows' step"]["share"] == 0.25


def test_needs_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert prefill_spans.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().out
