"""The launcher of a cell on several cards: one process a rank, rank 0's
result passed on, every rank waited for, a failing rank failing the run."""

import textwrap

from portbench import ranks

FAKE = textwrap.dedent("""
    import sys
    a = sys.argv
    rank = int(a[a.index("--rank") + 1])
    assert a[a.index("--world") + 1] == "3" and a[a.index("--init") + 1].startswith("tcp://localhost:")
    print('{"rank": %d}' % rank)
    sys.exit(int(a[a.index("--fail") + 1]) if "--fail" in a and rank == 1 else 0)
""")


def test_launch_passes_rank_zeros_line(tmp_path, monkeypatch, capsys):
    script = tmp_path / "run.py"
    script.write_text(FAKE)
    monkeypatch.setattr(ranks, "RUN", script)
    assert ranks.launch(["--workload", "x"], 3) == 0
    assert capsys.readouterr().out.strip() == '{"rank": 0}'


def test_launch_fails_when_a_rank_fails(tmp_path, monkeypatch, capsys):
    script = tmp_path / "run.py"
    script.write_text(FAKE)
    monkeypatch.setattr(ranks, "RUN", script)
    assert ranks.launch(["--fail", "3"], 3) == 3
    assert capsys.readouterr().out == ""
