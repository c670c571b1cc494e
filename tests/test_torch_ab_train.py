"""The port's training-step A/B trio (``experiments/ab_train.py``,
``experiments/capture_trace.py``, ``tools/select_bench_tuning.py``)
against the JAX scripts, on the CPU.

* ``_logged_tags`` equals JAX's on one log (records, a garbage line) and
  on a missing file;
* ``VARIANTS`` and ``TAG_TO_TUNING`` are JAX's without exactly the six
  tags whose optimizer is not optax Adam, knob for knob, and every tag
  but the ``nodrop`` bound and the ``smoke`` tags is selectable, as
  ``tests/test_ab_train.py`` holds JAX's;
* ``capture_trace`` of ``smoke_b2_k1`` at 16^3 (``ab_train.measure`` with
  a trace) prints JAX's record keys plus ``card`` and writes a trace that
  ``tools/analyze_trace.py`` reads;
* the CLI measures a tag in a child process, then skips it on a second
  run; a failing child makes the parent exit 1 and name the tag, and a
  child whose batch does not fit names it;
* the selector picks JAX's winner and prints JAX's JSON line on the same
  logs, for a lever that wins by more than 1%, one within 1% (the
  incumbent kept) and no base (exit 1, nothing written). JAX's ``main``
  runs only with its ``REPO`` in the test's directory and no recorded
  fallbacks, so it never writes the repo's ``configs/bench_tuning.json``,
  whose bytes are checked unchanged.
"""

import importlib.util
import json
import os
import subprocess

import pytest
import torch

from vnet_tpu_torch.experiments import ab_train, capture_trace
from vnet_tpu_torch.tools import analyze_trace, select_bench_tuning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_TAGS = {"flatadam_b96_k4", "combo_pdrop_flatadam_b96_k4",
            "cdw_flatadam_b96_k4", "cdw_all_b96_k4", "flatstate_b96_k16",
            "smoke_flat_b2_k1"}
RECORD_KEYS = {"exp", "patches_per_s", "step_ms", "compile_s", "batch",
               "scan", "side", "times_s"}
TUNING = os.path.join(REPO, "configs", "bench_tuning.json")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_ab = _load("ab_train_jax", "scripts/experiments/ab_train.py")
jax_selector = _load("select_bench_tuning_jax",
                     "scripts/select_bench_tuning.py")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_logged_tags_match_jax(tmp_path):
    log = tmp_path / "exp.log"
    log.write_text(
        json.dumps({"exp": "base_b96_k4", "patches_per_s": 200.0}) + "\n"
        + "garbage line\n{not json patches_per_s\n"
        + json.dumps({"exp": "cdw_b96_k4", "patches_per_s": 201.0}) + "\n"
        + json.dumps({"exp": "pdrop_b96_k4"}) + "\n")
    assert ab_train._logged_tags(str(log)) == jax_ab._logged_tags(str(log))
    assert ab_train._logged_tags(str(log)) == {"base_b96_k4", "cdw_b96_k4"}
    missing = str(tmp_path / "missing.log")
    assert ab_train._logged_tags(missing) == jax_ab._logged_tags(missing) \
        == set()


def test_tags_are_jax_without_the_optimizer_tags():
    assert {t for t, v in jax_ab.VARIANTS.items()
            if v["opt"] != "adam"} == OPT_TAGS
    assert ab_train.VARIANTS == {
        tag: {k: x for k, x in v.items() if k != "opt"}
        for tag, v in jax_ab.VARIANTS.items() if tag not in OPT_TAGS}
    assert len(ab_train.VARIANTS) == 17
    assert select_bench_tuning.TAG_TO_TUNING == {
        tag: t for tag, t in jax_selector.TAG_TO_TUNING.items()
        if tag not in OPT_TAGS}
    assert len(select_bench_tuning.TAG_TO_TUNING) == 15
    for tag, tuning in select_bench_tuning.TAG_TO_TUNING.items():
        v = ab_train.VARIANTS[tag]
        assert tuning.get("batch", 96) == v["batch"], tag
        assert tuning.get("scan", 4) == v["scan"], tag
        assert tuning.get("dropout_impl", "xla") == v["impl"], tag
        assert tuning.get("dw_impl", "xla") == v["dw"], tag
    for tag in ab_train.VARIANTS:
        assert (tag in select_bench_tuning.TAG_TO_TUNING) != tag.startswith(
            ("nodrop", "smoke")), tag


def test_measure_record_and_its_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert capture_trace.main(["smoke_b2_k1", "--trace-dir", str(trace_dir),
                               "--side", "16", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    jax_source = open(os.path.join(REPO, "scripts", "experiments",
                                   "ab_train.py")).read()
    assert all(f'"{k}":' in jax_source for k in RECORD_KEYS)
    assert set(rec) == RECORD_KEYS | {"card"} and rec["card"] is None
    assert (rec["exp"], rec["batch"], rec["scan"], rec["side"]) == (
        "smoke_b2_k1", 2, 1, 16)
    assert len(rec["times_s"]) == 2 and rec["times_s"] == sorted(
        rec["times_s"])
    assert rec["patches_per_s"] > 0 and rec["step_ms"] > 0
    path = analyze_trace.find_trace(str(trace_dir))
    events = analyze_trace.read_events(path)
    assert any(ev.get("ph") == "X" for ev in events)
    summary = analyze_trace.summarize(events)
    assert summary["busy_ms"] == 0.0  # no device on the CPU
    with pytest.raises(SystemExit, match="no device events in .*trace_"):
        analyze_trace.main([str(trace_dir)])


def test_cli_runs_a_tag_in_a_child_then_skips_it(tmp_path, capsys,
                                                 monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    log = str(tmp_path / "logs" / "ab.log")
    argv = ["smoke_b2_k1", "--log", log, "--side", "16", "--reps", "1",
            "--device", "cpu"]
    assert ab_train.main(argv) == 0
    with open(log) as f:
        (line,) = f.read().splitlines()
    assert json.loads(line)["exp"] == "smoke_b2_k1"
    capsys.readouterr()
    assert ab_train.main(argv) == 0
    assert capsys.readouterr().out.splitlines() == [
        f"smoke_b2_k1: already in {log}; skipping",
        "all requested tags already measured"]


def test_cli_names_the_tags_that_failed(tmp_path, capsys, monkeypatch):
    ran = []

    def child(cmd, env, timeout):
        ran.append(cmd[3])
        return subprocess.CompletedProcess(cmd, 1 if ran[-1] ==
                                           "base_b128_k16" else 0)

    monkeypatch.setattr(ab_train.subprocess, "run", child)
    assert ab_train.main(["base_b96_k4", "base_b128_k16", "drop8_b96_k4",
                          "--log", str(tmp_path / "ab.log"), "--device",
                          "cpu"]) == 1
    assert ran == ["base_b96_k4", "base_b128_k16", "drop8_b96_k4"]
    assert "failed: base_b128_k16" in capsys.readouterr().err

    def too_big(tag, *args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(ab_train, "measure", too_big)
    assert ab_train.main(["base_b128_k16", "--log", str(tmp_path / "ab.log"),
                          "--device", "cpu", "--inproc"]) == 1
    assert ("base_b128_k16: does not fit in the card's memory at batch 128"
            in capsys.readouterr().err)
    assert not (tmp_path / "ab.log").exists()


def _write_logs(root, records):
    """The records split over two of the JAX selector's log names, with a
    garbage line; returns the two paths."""
    paths = [root / "tmp" / "exp_r2b.log", root / "tmp" / "exp_r5tune.log"]
    paths[0].parent.mkdir(parents=True, exist_ok=True)
    half = len(records) // 2
    for path, recs in zip(paths, (records[:half], records[half:])):
        path.write_text("".join(json.dumps(r) + "\n" for r in recs)
                        + "not a record\n")
    return [str(p) for p in paths]


def _rec(tag, pps):
    return {"exp": tag, "patches_per_s": pps, "step_ms": 1.0,
            "card": "NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.mark.parametrize("records,winner", [
    # a lever beats the best incumbent (drop8 at scan 16) by > 1%
    ([_rec("base_b96_k4", 200.0), _rec("drop8_b96_k16", 210.0),
      _rec("pdw_b96_k16", 213.0), _rec("pdw_b96_k16", 215.0),
      _rec("nodrop_b96_k4", 300.0)], "pdw_b96_k16"),
    # the fastest lever is within 1% of the incumbent: it stays
    ([_rec("base_b96_k4", 200.0), _rec("base_b96_k16", 210.0),
      _rec("cdw_b96_k4", 212.0), _rec("smoke_b2_k1", 500.0)],
     "base_b96_k16"),
    # no base measurement: nothing is written
    ([_rec("pdw_b96_k16", 215.0), _rec("drop8_b96_k16", 210.0)], None),
])
def test_selector_matches_jax(tmp_path, capsys, monkeypatch, records,
                              winner):
    with open(TUNING, "rb") as f:
        repo_tuning = f.read()
    logs = _write_logs(tmp_path, records)
    (tmp_path / "configs").mkdir()
    monkeypatch.setattr(jax_selector, "REPO", str(tmp_path))
    monkeypatch.setattr(jax_selector, "RECORDED_FALLBACKS", {})
    code = 1 if winner is None else 0
    assert jax_selector.main() == code
    ref = capsys.readouterr().out.splitlines()
    out = tmp_path / "port" / "tuning.json"
    assert select_bench_tuning.main(["--log", *logs, "--out",
                                     str(out)]) == code
    got = capsys.readouterr().out.splitlines()
    jax_out = tmp_path / "configs" / "bench_tuning.json"
    if winner is None:
        assert got == ref == ["no base measurement yet; not writing tuning"]
        assert not out.exists() and not jax_out.exists()
    else:
        # the decision lines and the JSON line; then the file written
        n = len(ref) - 2
        assert got[:n] == ref[:n] and got[-1] == ref[-1] == "WINNER_SELECTED"
        assert json.loads(got[n - 1])["winner"] == winner
        port, jax = json.loads(out.read_text()), json.loads(
            jax_out.read_text())
        source = port.pop("_source")
        jax.pop("_source")
        assert port == jax == select_bench_tuning.TAG_TO_TUNING[winner]
        assert source["winner"] == winner and source["logs"] == logs
        assert source["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    with open(TUNING, "rb") as f:
        assert f.read() == repo_tuning


def test_selector_refuses_the_jax_tuning_file(tmp_path):
    logs = _write_logs(tmp_path, [_rec("base_b96_k4", 200.0)])
    with open(TUNING, "rb") as f:
        repo_tuning = f.read()
    with pytest.raises(SystemExit):
        select_bench_tuning.main(["--log", *logs, "--out", TUNING])
    with open(TUNING, "rb") as f:
        assert f.read() == repo_tuning


def test_selector_default_logs_are_jax_s():
    source = open(os.path.join(REPO, "scripts",
                               "select_bench_tuning.py")).read()
    at = [source.index(f'"{log}"') for log in select_bench_tuning.LOGS]
    assert len(at) == 5 and at == sorted(at)
