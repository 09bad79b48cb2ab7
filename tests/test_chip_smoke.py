"""chip_smoke.py's phases at tiny sizes on the CPU: the same code the card
runs at full size, checked here for control flow and exact agreement."""

import importlib.util
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    m = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = m
    spec.loader.exec_module(m)
    return m


def _say(lines):
    return lines.append


def test_main_refuses_cpu(capsys):
    cs = _load()
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok": true' not in out.out
    assert "no GPU" in out.err


def test_phase_golden(tmp_path):
    cs = _load()
    lines = []
    cs.phase_golden(str(tmp_path), _say(lines))
    assert len(lines) == len(cs.GOLDEN_DRIVES) + 1
    assert all("identical" in ln for ln in lines)


def test_phase_reference(tmp_path):
    cs = _load()
    lines = []
    cs.phase_reference(str(tmp_path), _say(lines), seed=3,
                       positions=1 << 16, read_len=1500, genome_len=20_000)
    assert "all profiles identical" in lines[0]


def test_phase_full_incore_vs_out_of_core(tmp_path, monkeypatch):
    """The three phase-3 drives at tiny size. Nothing this small leaves
    the in-core plan by itself, so the out-of-core drive runs under a
    device budget that fits nothing."""
    cs = _load()
    import fastk_tpu.jaxenv as jaxenv

    wd = str(tmp_path)
    fasta, bases, ninst = cs.make_survey_input(wd, 0, 0.03, 20,
                                               read_len=1500)
    assert bases == 20 * 30_000 and ninst == 400 * (1500 - 39)
    a = cs.drive("a", ["-k40"], fasta, wd)
    b = cs.drive("b", ["-k40", "-t3", "-p", "-M64"], fasta, wd)
    with monkeypatch.context() as mp:
        mp.setattr(jaxenv, "device_memory_budget", lambda device=None: 1)
        c = cs.drive("c", ["-k40", "-t3", "-p"], fasta, wd)
    assert (a["path"], b["path"], c["path"]) == (
        "in-core", "in-core", "out-of-core")
    assert cs.check_full(a, c, b, ninst) > 0
    lines = []
    cs._report(_say(lines), c, 1 << 30)
    assert "path out-of-core" in lines[0]


def test_phase_placement_tiny():
    cs = _load()
    lines = []
    times = cs.phase_placement(_say(lines), size=1 << 12, reps=1)
    assert set(times) == {"scatter", "sort (replaced)"} and len(lines) == 2


@pytest.mark.gpu
def test_reference_phase_on_gpu(gpu, tmp_path):
    """Phase 2 at full device width: what chip_smoke.py runs on the card."""
    cs = _load()
    lines = []
    cs.phase_reference(str(tmp_path), _say(lines), seed=0)
    assert "all profiles identical" in lines[0]

