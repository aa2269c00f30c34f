"""The port's sampling profiler (``bluefog_tpu_torch/profiling/``) against
the JAX package's (``bluefog_tpu/profiling/``), following the host-path
cases of ``tests/test_profiling.py``: phase attribution 80/20 and
phase-only tracking without tracing; env arming with a ``reset`` that
sticks, and bad rates; the merge's torn tail, ``phase_frames``, the
diff's exit codes and its new hot frame, each against the JAX package's
report functions on the same files; the CLI and an empty directory; the
thread runner's ``profile=``; the recent window.  Each package's report
reads the other's profile files.

Left out: ``test_disabled_no_thread_and_identical_hlo``'s HLO half (the
port compiles no program; its no-thread half is here),
``test_blackbox_dump_embeds_profile`` and ``test_recorder_recent_window``
(the flight recorder is ROADMAP item 11a-ii),
``test_fleet_record_profile_digest_roundtrip`` (``fleet/``, item 11b), and
the lint cases (``analysis/``, item 11c).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bluefog_tpu_torch.profiling as PP
from bluefog_tpu.profiling import report as RR
from bluefog_tpu.profiling import sampler as RS
from bluefog_tpu.profiling.cli import main as ref_main
from bluefog_tpu.tracing import recorder as RT
from bluefog_tpu_torch import topology as ptopo
from bluefog_tpu_torch.profiling import report as PR
from bluefog_tpu_torch.profiling import sampler as PS
from bluefog_tpu_torch.profiling.cli import main as prof_main
from bluefog_tpu_torch.runtime import async_windows as aw
from bluefog_tpu_torch.tracing import recorder as PT
from tests._util import REPO, clean_env


def _sampler_threads():
    return [t for t in threading.enumerate()
            if t.name == PS.Profiler.THREAD_NAME]


@pytest.fixture(autouse=True)
def _no_leaked_profiler():
    """Every case leaves the process with no sampler thread and phase
    tracking off in either package."""
    yield
    PS.reset()
    RS.reset()
    PT.reset()
    assert not _sampler_threads()
    assert not PT.phase_tracking()


def _busy_until(deadline):
    x = 0
    while time.perf_counter() < deadline:
        x += 1
    return x


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------


def test_phase_attribution_80_20(tmp_path):
    """A worker spending ~80% of its wall time in a compute span and ~20%
    in a gossip span is attributed within 10 percentage points."""
    PP.configure(str(tmp_path), rank=0, hz=400)
    stop = time.perf_counter() + 1.6

    def worker():  # its own thread: the main thread carries pytest frames
        while time.perf_counter() < stop:
            with PT.span("compute", "test"):
                _busy_until(time.perf_counter() + 0.008)
            with PT.span("gossip", "test"):
                _busy_until(time.perf_counter() + 0.002)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join()
    PS.reset()
    rep = PP.merge(str(tmp_path))
    comp = rep["phases"].get("compute", 0)
    goss = rep["phases"].get("gossip", 0)
    assert comp + goss >= 100, rep["phases"]
    assert 0.70 <= comp / (comp + goss) <= 0.90
    assert rep["attributed_frac"] > 0.0
    assert rep["ranks"] == [0]
    # the JAX package's report reads the port's files the same way
    assert json.dumps(RR.merge(str(tmp_path)), sort_keys=True) == \
        json.dumps(rep, sort_keys=True)


def test_phase_only_tracking_without_tracing(tmp_path):
    """span() keeps the phase map for the sampler with tracing off, and
    drops back to the free null context manager once disarmed."""
    assert PT.span("compute", "t") is PT._NULL_CM
    PP.configure(str(tmp_path), rank=0, hz=50)
    assert PT.phase_tracking()
    cm = PT.span("compute", "t", round_=3)
    assert cm is not PT._NULL_CM
    with cm:
        assert PT.active_phases()[threading.get_ident()] == ("compute", 3)
    assert threading.get_ident() not in PT.active_phases()
    PS.reset()
    assert PT.span("compute", "t") is PT._NULL_CM
    # the JAX package's phase map is its own
    assert not RT.phase_tracking()


@pytest.mark.parametrize("name", ["compute", "round", "gossip", "consume",
                                  "apply", "publish", "control", "wire",
                                  "ack_wait", "queue_wait", "coalesce",
                                  "fleet", "loss_and_grad", None])
def test_span_phases_match_the_jax_package(name):
    assert PS.phase_for_span(name) == RS.phase_for_span(name)
    assert PS.PHASES == RS.PHASES


# ---------------------------------------------------------------------------
# the disabled path and arming
# ---------------------------------------------------------------------------


def test_disabled_means_no_thread():
    assert PS.get() is None
    assert not _sampler_threads()
    code = ("import threading, bluefog_tpu_torch.profiling as p\n"
            "import bluefog_tpu_torch.runtime.async_windows\n"
            "assert p.get() is None\n"
            "assert not [t for t in threading.enumerate()\n"
            "            if t.name == p.Profiler.THREAD_NAME]\n"
            "print('OFF')\n")
    env = clean_env()
    env.pop("BLUEFOG_TPU_PROFILE", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OFF" in proc.stdout


def test_env_lazy_arming_and_sticky_reset(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_TPU_PROFILE", str(tmp_path))
    # an earlier reset() left the stop sticky by design: model a fresh
    # process
    monkeypatch.setattr(PS, "_STOPPED", False)
    prof = PS.get()
    assert prof is not None and prof.directory == str(tmp_path)
    assert _sampler_threads()
    PS.reset()
    assert PS.get() is None  # the variable alone does not resurrect it
    assert PS.configure(str(tmp_path), rank=1) is PS.get()  # configure does
    PS.reset()


@pytest.mark.parametrize("hz", [-5, -0.5, 5000, 1000.5])
def test_bad_hz_rejected(tmp_path, hz):
    for mod in (PS, RS):
        with pytest.raises(ValueError):
            mod.Profiler(str(tmp_path), hz=hz)


@pytest.mark.parametrize("value,hz", [("", 97.0), ("250", 250.0),
                                      ("fast", 97.0)])
def test_env_hz_like_the_jax_package(tmp_path, monkeypatch, value, hz):
    monkeypatch.setenv("BLUEFOG_TPU_PROFILE_HZ", value)
    assert PS.Profiler(str(tmp_path)).hz == RS.Profiler(str(tmp_path)).hz \
        == hz


# ---------------------------------------------------------------------------
# the merge, the report and the diff
# ---------------------------------------------------------------------------


def _window(rank, t0, t1, stacks):
    phases = {}
    for ph, _, n in stacks:
        phases[ph] = phases.get(ph, 0) + n
    return {"kind": "window", "t0": t0, "t1": t1, "rank": rank,
            "hz": 97.0, "samples": sum(n for _, _, n in stacks),
            "phases": phases, "stacks": stacks}


def test_merge_tolerates_torn_tail(tmp_path):
    lines = [
        json.dumps({"kind": "meta", "rank": 0, "pid": 1, "hz": 97.0,
                    "t0": 10.0}),
        json.dumps(_window(0, 10.0, 11.0, [["compute", "a;b", 5]])),
        json.dumps(_window(0, 11.0, 12.0, [["compute", "a;b", 3],
                                           ["net-wait", "a;c", 2]])),
    ]
    (tmp_path / "profile-rank0.jsonl").write_text(
        "\n".join(lines) + "\n" + '{"kind": "wind')  # a torn tail
    (tmp_path / "profile-rank1.jsonl").write_text(json.dumps(
        _window(1, 10.5, 11.5, [["compute", "a;b", 4]])) + "\n")
    rep = PR.merge(str(tmp_path))
    assert rep["ranks"] == [0, 1]
    assert rep["samples"] == 14  # the torn record adds nothing
    assert rep["frames"]["b"]["self"] == 12
    assert rep["frames"]["a"]["total"] == 14
    assert rep["wall_s"] == 2.0
    assert "compute;a;b 12" in PR.render_folded(rep)
    svg = PR.render_svg(rep)
    assert svg.startswith("<svg") and "compute" in svg
    assert rep == RR.merge(str(tmp_path))
    assert PR.render_folded(rep) == RR.render_folded(rep)
    assert PR.top_table(rep, 5) == RR.top_table(rep, 5)


def _random_dir(path, seed):
    rng = np.random.default_rng(seed)
    frames = ["m.py:f", "m.py:g", "n.py:h", "n.py:loop", "o.py:wait"]
    for rank in range(3):
        with open(os.path.join(path, f"profile-rank{rank}.jsonl"), "w") as f:
            for w in range(4):
                stacks = []
                for _ in range(int(rng.integers(1, 6))):
                    depth = int(rng.integers(1, 4))
                    folded = ";".join(rng.choice(frames, depth))
                    stacks.append([str(rng.choice(
                        ["compute", "gossip", "net-wait", "publish"])),
                        folded, int(rng.integers(1, 50))])
                f.write(json.dumps(_window(rank, w, w + 1.0, stacks)) + "\n")


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_directory_gives_equal_reports(tmp_path, seed):
    _random_dir(str(tmp_path), seed)
    rep = PR.merge(str(tmp_path))
    assert rep == RR.merge(str(tmp_path))
    assert PR.render_svg(rep, title="t") == RR.render_svg(rep, title="t")
    for phase in ("compute", "net-wait"):
        assert PR.phase_frames(rep, phase) == RR.phase_frames(rep, phase)


def test_phase_frames_names_leafs():
    rep = {"stacks": [["net-wait", "a;b;wait_loop", 7],
                      ["net-wait", "a;wait_loop", 3],
                      ["compute", "a;matmul", 9]]}
    assert PR.phase_frames(rep, "net-wait")[0] == ("wait_loop", 10)
    assert PR.phase_frames(rep, "net-wait") == RR.phase_frames(rep,
                                                               "net-wait")


def _report_json(tmp_path, name, frames, samples):
    rep = {"kind": "bfprof_report", "samples": samples,
           "frames": {fr: {"self": n, "total": n} for fr, n in frames.items()},
           "phases": {}, "phase_frac": {}, "attributed_frac": 0.0,
           "ranks": [0], "stacks": []}
    path = tmp_path / name
    path.write_text(json.dumps(rep))
    return str(path)


def test_diff_exit_codes(tmp_path, capsys):
    base = _report_json(tmp_path, "base.json",
                        {"hot": 500, "warm": 300, "cold": 200}, 1000)
    clean = _report_json(tmp_path, "clean.json",
                         {"hot": 510, "warm": 290, "cold": 200}, 1000)
    regr = _report_json(tmp_path, "regr.json",
                        {"hot": 700, "warm": 150, "cold": 150}, 1000)
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    cases = [(["--diff", base, clean], 0), (["--diff", base, regr], 3),
             (["--diff", base, regr, "--threshold", "0.9"], 0),
             (["--diff", base, str(tmp_path / "missing.json")], 2),
             (["--diff", base, str(bad)], 2),
             ([str(tmp_path / "no_such_dir")], 2), ([], 2)]
    for argv, rc in cases:  # the JAX package's exit codes, case by case
        assert prof_main(argv) == rc, argv
        assert ref_main(argv) == rc, argv
    capsys.readouterr()
    prof_main(["--diff", base, regr])
    out = capsys.readouterr().out
    assert '"ok": false' in out and "hot" in out


def test_diff_flags_new_hot_frame():
    base = {"samples": 1000, "frames": {"a": {"self": 1000}}}
    head = {"samples": 1000, "frames": {"a": {"self": 900},
                                        "newcomer": {"self": 100}}}
    v = PR.diff(base, head)
    assert not v["ok"]
    assert v["regressions"][0]["frame"] == "newcomer"
    assert v["regressions"][0]["new"] is True
    assert v == RR.diff(base, head)


def test_cli_report_and_empty_dir(tmp_path, capsys):
    assert prof_main([str(tmp_path)]) == 2  # no samples: a usage error
    capsys.readouterr()
    (tmp_path / "profile-rank0.jsonl").write_text(
        json.dumps(_window(0, 0.0, 1.0, [["compute", "m:f", 10]])) + "\n")
    assert prof_main([str(tmp_path), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "m:f" in out and "compute" in out
    svg_path = tmp_path / "fg.svg"
    assert prof_main([str(tmp_path), "--svg", str(svg_path)]) == 0
    assert svg_path.read_text().startswith("<svg")
    capsys.readouterr()
    assert prof_main([str(tmp_path), "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["kind"] == "bfprof_report"
    # a --json report of either package feeds the other's --diff
    path = tmp_path / "rep.json"
    path.write_text(json.dumps(rep))
    assert ref_main(["--diff", str(path), str(path)]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.profiling", str(tmp_path),
         "--folded"], capture_output=True, text=True, timeout=120,
        env=clean_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "compute;m:f 10" in proc.stdout


# ---------------------------------------------------------------------------
# the runners and the recent window
# ---------------------------------------------------------------------------


def test_thread_runner_profile_wiring(tmp_path):
    def loss_and_grad(rank, step, params):
        _busy_until(time.perf_counter() + 0.002)
        return 0.0, {"x": params["x"] * 0.0}

    report = aw.run_async_dsgd(
        ptopo.RingGraph(2), {"x": torch.zeros(4)}, loss_and_grad,
        duration_s=1.0, name=f"dsgd_prof_{os.getpid()}",
        profile=str(tmp_path))
    assert abs(report.total_mass - 2) < 1e-9
    # the runner stopped the sampler it started...
    assert PS.get() is None
    assert not _sampler_threads()
    # ...after it wrote this run's profile
    assert (tmp_path / "profile-rank0.jsonl").exists()
    rep = PR.merge(str(tmp_path))
    assert rep["samples"] > 0
    assert rep == RR.merge(str(tmp_path))


def test_runner_leaves_an_env_armed_profiler_running(tmp_path, monkeypatch):
    monkeypatch.setenv("BLUEFOG_TPU_PROFILE", str(tmp_path / "env"))
    monkeypatch.setattr(PS, "_STOPPED", False)
    aw.run_async_dsgd(
        ptopo.RingGraph(2), {"x": torch.zeros(4)},
        lambda r, s, p: (0.0, {"x": p["x"] * 0.0}), duration_s=0.3,
        name=f"dsgd_prof_env_{os.getpid()}", profile=str(tmp_path / "arg"))
    prof = PS.get()
    assert prof is not None and prof.directory == str(tmp_path / "env")
    assert not (tmp_path / "arg").exists()


def test_recent_window_ages_out_like_the_jax_package(tmp_path):
    """The bounded recent window: samples older than the window fall out
    of ``recent_folded``."""
    now = time.time()
    samples = [(now - 120.0, "a;old", "compute", 0),
               (now - 1.0, "a;b", "compute", 1),
               (now - 0.5, "a;b", "gossip", 1),
               (now - 0.2, "a;c", "net-wait", 2)]
    got = []
    for mod in (PS, RS):
        prof = mod.Profiler(str(tmp_path), rank=0, hz=50)
        prof._recent.extend(samples)
        got.append((prof.recent_folded(60.0), prof.recent_folded(300.0)))
    assert got[0] == got[1]
    win, whole = got[0]
    assert win["samples"] == 3 and win["stacks"] == {"a;b": 2, "a;c": 1}
    assert win["phases"] == {"compute": 1, "gossip": 1, "net-wait": 1}
    assert whole["samples"] == 4
