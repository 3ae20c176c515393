"""The port's ``tools/window_promote.py`` (``python -m
pytorch_mnist_ddp_tpu_torch.tools.window_promote``) held against the JAX
package's ``tools/window_promote.py``.

Every case of ``tests/test_bench.py``'s ``test_window_promote_rules`` and
``test_count_rungs_ignores_float_metadata_keys`` runs through both modules,
each in a directory of its own with the same file names: both return the
same outcome string and leave the same bytes at the destination and its
``.err`` sidecar (or leave both absent), and the outcome says what JAX's
test asserts.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

import pytest

from pytorch_mnist_ddp_tpu_torch.tools import window_promote as port
from pytorch_mnist_ddp_tpu_torch.tools.step_attr_bench import RUNG_NAMES

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_window_promote",
                                                  ROOT / "tools" / "window_promote.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tool()

ABSENT = None
NOT_JSON = "{not json"
TRUNCATED = {"batch": 200, "full": 900.0, "elapsed_s": 12.5, "budget_s": 540.0,
             "overhead_s": 0.25, "partial": True}

# (rule, src row, src .err, dst row before, dst .err before, what the
# outcome says); a row is a dict (written as JSON), raw text, or ABSENT.
CASES = {
    # value: the first record promotes, its .err along; slower keeps;
    # faster promotes
    "value_first_record_and_its_err": (
        "value", {"value": 26.0}, "warm log", ABSENT, ABSENT, "promoted 26.0"),
    "value_slower_keeps": (
        "value", {"value": 30.0}, "warm log", {"value": 26.0}, "warm log", "kept 26.0"),
    "value_faster_promotes": (
        "value", {"value": 9.3}, "new log", {"value": 26.0}, "old log", "promoted 9.3"),
    # a failure row or bytes that do not parse never replace a measurement
    "value_failure_row_keeps": (
        "value", {"value": None, "error": "tunnel died"}, ABSENT, {"value": 9.3}, ABSENT,
        "kept incumbent"),
    "value_unparseable_keeps": (
        "value", NOT_JSON, ABSENT, {"value": 9.3}, ABSENT, "kept incumbent"),
    # ...nor land on an absent destination
    "value_failure_row_never_lands": (
        "value", {"value": None, "error": "tunnel died"}, "log", ABSENT, ABSENT,
        "kept incumbent"),
    # rungs: the first partial lands on nothing; fewer keeps; more promotes
    "rungs_first_partial_lands": (
        "rungs", {"batch": 200, "full": 830.0, "fwd_bwd": 700.0}, ABSENT, ABSENT, ABSENT,
        "promoted (2 rungs over -1"),
    "rungs_fewer_keeps": (
        "rungs", {"batch": 200, "full": 820.0, "partial": True}, ABSENT,
        {"batch": 200, "full": 830.0, "fwd_bwd": 700.0}, ABSENT,
        "kept incumbent (2 rungs vs new 1"),
    "rungs_more_promotes": (
        "rungs", {"batch": 200, "full": 810.0, "fwd_bwd": 690.0, "eval": 900.0}, ABSENT,
        {"batch": 200, "full": 830.0, "fwd_bwd": 700.0}, ABSENT,
        "promoted (3 rungs over 2"),
    # ties break toward the lower full rung
    "rungs_tie_slower_full_keeps": (
        "rungs", {"batch": 200, "full": 3100.0, "fwd_bwd": 2900.0, "eval": 3500.0}, ABSENT,
        {"batch": 200, "full": 810.0, "fwd_bwd": 690.0, "eval": 900.0}, ABSENT,
        "kept incumbent (tie at 3 rungs"),
    "rungs_tie_faster_full_promotes": (
        "rungs", {"batch": 200, "full": 640.0, "fwd_bwd": 610.0, "eval": 700.0}, ABSENT,
        {"batch": 200, "full": 810.0, "fwd_bwd": 690.0, "eval": 900.0}, ABSENT,
        "promoted (3 rungs over 3"),
    # metadata floats are not rungs: a padded partial never clobbers
    "rungs_padded_partial_keeps": (
        "rungs", TRUNCATED, ABSENT,
        {"batch": 200, "full": 810.0, "fwd_bwd": 690.0, "eval": 900.0}, ABSENT,
        "kept incumbent"),
    "rungs_zero_rungs_never_land": (
        "rungs", {"batch": 200, "full": None, "partial": True}, ABSENT, ABSENT, ABSENT,
        "kept incumbent (-1 rungs vs new 0"),
}


def _put(path: pathlib.Path, row) -> None:
    if row is ABSENT:
        return
    path.write_text(row if isinstance(row, str) else json.dumps(row))


def _state(d: pathlib.Path) -> dict:
    return {name: (d / name).read_bytes() if (d / name).exists() else None
            for name in ("best.json", "best.err")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_modules_promote_alike(case, tmp_path, monkeypatch):
    rule, src, src_err, dst, dst_err, says = CASES[case]
    outcomes, states = {}, {}
    for name, module in (("jax", JAX), ("port", port)):
        d = tmp_path / name
        d.mkdir()
        _put(d / "run.json", src)
        _put(d / "run.err", src_err)
        _put(d / "best.json", dst)
        _put(d / "best.err", dst_err)
        monkeypatch.chdir(d)  # same relative names: the outcomes may quote them
        fn = module.promote_value if rule == "value" else module.promote_rungs
        outcomes[name] = fn("run.json", "best.json")
        states[name] = _state(d)
    assert outcomes["port"] == outcomes["jax"]
    assert says in outcomes["port"], outcomes
    assert states["port"] == states["jax"]
    promoted = "promoted" in says
    want = (tmp_path / "port" / "run.json").read_bytes() if promoted else (
        None if dst is ABSENT else (tmp_path / "port" / "best.json").read_bytes())
    assert states["port"]["best.json"] == want
    if rule == "value" and promoted and src_err is not ABSENT:
        assert states["port"]["best.err"] == src_err.encode()


@pytest.mark.parametrize("row", [
    TRUNCATED, {"full": 900.0, "fwd_bwd": None}, None, {"full": True, "eval": 1},
    {name: 1.5 for name in RUNG_NAMES}, {"value": 3.0, "elapsed_s": 1.0}])
def test_count_rungs_counts_alike(row):
    """Only known rung names holding a number count (a bool is no
    measurement); no artifact is -1."""
    assert port.count_rungs(row) == JAX.count_rungs(row)


def test_count_rungs_pins_and_the_rung_names():
    assert port.count_rungs(TRUNCATED) == 1
    assert port.count_rungs({"full": 900.0, "fwd_bwd": None}) == 1
    assert port.count_rungs(None) == -1
    assert "full" in RUNG_NAMES and "eval" in RUNG_NAMES
    assert set(RUNG_NAMES) == set(JAX.RUNG_NAMES)


def test_the_cli(tmp_path, monkeypatch, capsys):
    """JAX's usage and exit codes: 0 whether or not it promotes (the
    outcome printed), 2 on bad usage."""
    monkeypatch.chdir(tmp_path)
    _put(tmp_path / "run.json", {"value": 5.0})
    assert port.main(["value", "run.json", "best.json"]) == 0
    assert capsys.readouterr().out == "promoted 5.0 (previous None)\n"
    assert port.main(["value", "run.json", "best.json"]) == 0
    assert capsys.readouterr().out == "kept 5.0 (new run 5.0 is slower)\n"
    assert port.main(["rungs", "run.json", "ladder.json"]) == 0
    assert capsys.readouterr().out == "stepattr kept incumbent (-1 rungs vs new 0)\n"
    for bad in ([], ["value", "run.json"], ["latest", "run.json", "best.json"],
                ["value", "run.json", "best.json", "extra"]):
        assert port.main(bad) == 2
        err = capsys.readouterr().err
        assert err.startswith("usage: ") and "{value|rungs} SRC.json DST.json" in err


def test_python_m_runs_as_the_jax_script(tmp_path):
    """``python -m pytorch_mnist_ddp_tpu_torch.tools.window_promote`` and
    ``python tools/window_promote.py`` over the same files: the same
    stdout, exit code and destination bytes; bad usage exits 2 for both."""
    import subprocess
    import sys

    runs = {"jax": [sys.executable, str(ROOT / "tools" / "window_promote.py")],
            "port": [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.tools.window_promote"]}
    seen = {}
    for name, cmd in runs.items():
        d = tmp_path / name
        d.mkdir()
        _put(d / "run.json", {"batch": 200, "full": 810.0, "fwd_bwd": 690.0})
        _put(d / "best.json", {"batch": 200, "full": 830.0, "fwd_bwd": 700.0})
        got = [subprocess.run([*cmd, *argv], cwd=d, capture_output=True, text=True,
                              env={"PYTHONPATH": str(ROOT), "PATH": ""})
               for argv in (["rungs", "run.json", "best.json"], ["value"])]
        seen[name] = ([(p.returncode, p.stdout) for p in got], _state(d))
        assert [p.returncode for p in got] == [0, 2], got
        assert got[1].stderr.startswith("usage: ")
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][0][1] == "stepattr promoted (2 rungs over 2)\n"
