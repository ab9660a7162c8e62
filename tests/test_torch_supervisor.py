"""The port's wedge watchdog (`sagnn_tpu_torch/train/supervisor.py`) on
the CPU: the detection criterion on synthetic readings, recovery of dummy
children whose state cannot change under load (a child that SIGSTOPs
itself burns exactly zero CPU; a crash is an exit code), the staging-file
clean-up, the child command `main --supervise` builds, and one supervised
training run recovered from an induced SIGSTOP.

No test here proves "not a wedge" with a CPU-busy child: such a child
can be starved on a loaded machine, and that case is held on synthetic
readings instead. Every wait on a subprocess has its own timeout.
"""

import os
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from sagnn_tpu.train.supervisor import child_cpu_seconds as j_cpu_seconds
from sagnn_tpu_torch import main as tmain
from sagnn_tpu_torch.train import supervisor as sup_mod
from sagnn_tpu_torch.train.supervisor import (Supervisor, Watch,
                                              child_cpu_seconds)

from tests.torch_threads import one_torch_thread

pytestmark = pytest.mark.usefixtures(one_torch_thread.__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import os, signal, sys, time
    ckpt, mode = sys.argv[1], sys.argv[2]
    if "--load_model" in sys.argv:
        print("Model Loaded, resuming at epoch 1", flush=True)
        sys.exit(0)
    if mode == "crash":
        print("Start", flush=True)
        sys.exit(3)
    def onterm(s, f):
        # as the Trainer's handler: the save's sidecar lands, then (here)
        # the handler hangs, so the supervisor must stop waiting on it
        with open(os.path.join(ckpt, "history.json"), "w") as fh:
            fh.write("{}")
        print("signal: writing preemption checkpoint", flush=True)
        time.sleep(600)
    signal.signal(signal.SIGTERM, onterm)
    with open(os.path.join(ckpt, "state.tmp"), "w") as fh:
        fh.write("partial")
    print("Start", flush=True)       # after the handler exists
    os.kill(os.getpid(), signal.SIGSTOP)
    time.sleep(600)
""")


def make_sup(tmp_path, mode, **kw):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir(exist_ok=True)
    args = dict(
        argv=[sys.executable, str(script), str(ckpt), mode],
        log_path=str(tmp_path / "train.log"), ckpt_dir=str(ckpt),
        resume_args=["--load_model", "tem"], check_every=0.2,
        wedge_secs=0.5, cpu_eps=0.2, term_grace=20.0, commit_settle=0.3,
        startup_grace=30.0, max_recoveries=3, relay_probe=None)
    args.update(kw)
    return Supervisor(**args), ckpt


def run_bounded(sup, timeout=90.0):
    """sup.run() on a thread with a deadline, so no test can hang."""
    out = {}
    th = threading.Thread(target=lambda: out.update(rc=sup.run()),
                          daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), "supervisor did not finish in time"
    return out["rc"]


# -- child_cpu_seconds ---------------------------------------------------------

def test_child_cpu_seconds_of_this_process():
    t_end = time.process_time() + 0.05
    while time.process_time() < t_end:
        pass
    me = child_cpu_seconds(os.getpid())
    assert me is not None and me > 0
    assert abs(me - j_cpu_seconds(os.getpid())) < 1.0
    assert child_cpu_seconds(2 ** 22 + 1234) is None


# -- the criterion on synthetic readings -----------------------------------------

def _feed(sup, readings, size0=0, cpu0=0.0):
    """Feed (size, cpu, now) readings to _decide; the first wedge's reason
    and its reading's index, or (None, None)."""
    w = Watch(last_size=size0, last_cpu=cpu0)
    for n, (size, cpu, now) in enumerate(readings):
        w, reason = sup._decide(w, size, cpu, now)
        if reason is not None:
            return reason, n
    return None, None


def _sup(**kw):
    args = dict(argv=["true"], log_path="/nonexistent", wedge_secs=10.0,
                cpu_eps=2.0, startup_grace=60.0, relay_probe=None)
    args.update(kw)
    return Supervisor(**args)


def test_log_silent_but_cpu_active_is_not_a_wedge():
    sup = _sup()
    # armed at t=1, then 50 s silent with 3 CPU-s every 5 s (past the
    # wedge window, short of the 60 s silent cap)
    readings = [(100, 1.0, 1.0)] + [(100, 1.0 + 3.0 * n, 1.0 + 5.0 * n)
                                    for n in range(1, 11)]
    assert _feed(sup, readings) == (None, None)


def test_silent_and_idle_for_wedge_secs_is_a_wedge():
    sup = _sup()
    readings = [(100, 1.0, 1.0)] + [(100, 1.5, 1.0 + 5.0 * n)
                                    for n in range(1, 6)]
    reason, n = _feed(sup, readings)
    # quiet from t=6 (first silent poll); 10 s later, at t=16 (n=3)
    assert n == 3 and reason.startswith("WEDGE: no log output")
    # the same readings a hair before the window ends: no wedge
    assert _feed(sup, readings[:3] + [(100, 1.5, 15.9)]) == (None, None)
    # a child gone (cpu None) keeps its last reading
    assert _feed(sup, readings[:2] + [(100, None, 16.0)])[1] == 2


def test_silent_cap_trips_despite_cpu():
    sup = _sup(silent_cap_secs=30.0)
    readings = [(100, 1.0, 1.0)] + [(100, 1.0 + 3.0 * n, 1.0 + 5.0 * n)
                                    for n in range(1, 10)]
    reason, n = _feed(sup, readings)
    # silent from t=6; the cap of 30 s trips at t=36 (n=7)
    assert n == 7 and "silent_cap" in reason
    # None: 6 x wedge_secs
    reason, n = _feed(_sup(), [(100, 1.0, 1.0)] + [
        (100, 1.0 + 3.0 * k, 1.0 + 10.0 * k) for k in range(1, 9)])
    assert n == 7 and "silent_cap 60s" in reason


def test_startup_grace_defers_detection_until_first_output():
    sup = _sup()
    idle = [(0, 0.0, 5.0 * n) for n in range(1, 20)]
    reason, n = _feed(sup, idle)
    # never logged: the window is max(wedge_secs, startup_grace) = 60 s
    # from the first quiet poll at t=5
    assert 5.0 * (n + 1) - 5.0 >= 60.0 and 5.0 * n - 5.0 < 60.0
    assert reason.startswith("WEDGE")
    # after a first line, wedge_secs alone
    logged = [(0, 0.0, 5.0), (7, 0.0, 10.0)] + [
        (7, 0.0, 10.0 + 5.0 * k) for k in range(1, 5)]
    assert _feed(sup, logged)[1] == 4
    # no silent cap before the first output
    assert "silent_cap" not in _feed(_sup(silent_cap_secs=1.0), idle)[0]


def test_unarmed_busy_silent_child_is_capped_from_the_spawn():
    """A child that never logs and keeps burning CPU (a relaunch stuck in
    device initialisation, spinning) is declared at max(silent_cap,
    startup_grace) after its spawn, where the JAX package never declares
    it."""
    def busy(sup, spawn=0.0, polls=40):
        """Polls every 5 s from t=5, 3 CPU-s each; (reason, t) of the
        wedge."""
        w = Watch(last_size=0, last_cpu=0.0, silent_since=spawn)
        for n in range(1, polls):
            w, reason = sup._decide(w, 0, 3.0 * n, 5.0 * n)
            if reason is not None:
                return reason, 5.0 * n
        return None, None

    # silent cap 60 (6 x wedge_secs) and startup_grace 60: at 60 s
    reason, at = busy(_sup())
    assert at == 60.0 and "silent_cap 60s" in reason
    # the larger of the two
    assert busy(_sup(silent_cap_secs=90.0))[1] == 90.0
    assert busy(_sup(silent_cap_secs=5.0, startup_grace=100.0))[1] == 100.0
    # counted from the spawn, not from the first poll
    assert busy(_sup(), spawn=-20.0)[1] == 40.0
    # a disabled cap stays disabled
    assert busy(_sup(silent_cap_secs=0.0)) == (None, None)


def test_decide_has_no_side_effects():
    sup = _sup()
    w = Watch(last_size=3, last_cpu=1.0, armed=True)
    w2, _ = sup._decide(w, 3, 1.0, 10.0)
    assert w == Watch(last_size=3, last_cpu=1.0, armed=True)
    assert w2.quiet_since == 10.0 and w2.silent_since == 10.0
    assert sup.events == [] and sup.recoveries == 0


# -- dummy children ---------------------------------------------------------------

def test_sigstopped_child_recovers_via_sigcont_sigterm(tmp_path):
    sup, ckpt = make_sup(tmp_path, "sigstop")
    assert run_bounded(sup) == 0
    assert sup.recoveries == 1
    joined = "\n".join(sup.events)
    assert "WEDGE" in joined and "SIGCONT+SIGTERM" in joined
    log = (tmp_path / "train.log").read_text()
    assert "writing preemption checkpoint" in log     # handler ran
    assert "Model Loaded" in log                      # relaunch resumed
    assert not (ckpt / "state.tmp").exists()
    assert (ckpt / "history.json").exists()


def test_crash_relaunches_with_resume_args(tmp_path):
    sup, _ = make_sup(tmp_path, "crash")
    assert run_bounded(sup) == 0
    assert sup.recoveries == 1
    assert any("crashed rc=3" in e for e in sup.events)
    relaunch = [e for e in sup.events if "launched pid" in e][-1]
    assert relaunch.endswith("--load_model tem")
    assert "Model Loaded" in (tmp_path / "train.log").read_text()


def test_recovery_budget_runs_out(tmp_path):
    # resume args the child ignores: it stops itself on every launch
    sup, _ = make_sup(tmp_path, "sigstop", resume_args=[], max_recoveries=1)
    assert run_bounded(sup) == 1
    assert sup.recoveries == 2       # the budget of 1 and the one refused
    assert any("budget exhausted" in e for e in sup.events)
    # giving up leaves no child holding the card
    out = subprocess.run(["ps", "-eo", "args"], capture_output=True,
                         text=True, timeout=30).stdout
    assert str(tmp_path / "child.py") not in out


def test_giving_up_cleans_staging_files(tmp_path):
    """When the recovery budget runs out the last child's staging files go
    too, as after a recovery."""
    sup, ckpt = make_sup(tmp_path, "sigstop", resume_args=[],
                         max_recoveries=1)
    assert run_bounded(sup) == 1
    assert any("budget exhausted" in e for e in sup.events)
    assert not (ckpt / "state.tmp").exists()
    assert sum("removing partial checkpoint" in e for e in sup.events) == 2


def test_clean_tmp_removes_staging_files_only(tmp_path):
    for name in ("state", "state.tmp", "history.json", "history.json.tmp",
                 "rng.json.tmp", "config.json"):
        (tmp_path / name).write_text("x")
    sup = Supervisor(argv=["true"], log_path=str(tmp_path / "log"),
                     ckpt_dir=str(tmp_path), relay_probe=None)
    sup._clean_tmp()
    assert sorted(os.listdir(tmp_path)) == ["config.json", "history.json",
                                            "state"]


def test_relay_probe_defaults_to_a_cuda_op():
    probe = Supervisor(argv=["true"], log_path="x").relay_probe
    assert probe[0] == sys.executable and "device='cuda'" in probe[-1]
    assert "jax" not in probe[-1]


# -- main --supervise -------------------------------------------------------------

@pytest.mark.parametrize("device,probe", [("cpu", False), ("cuda", True)])
def test_supervise_builds_the_child_command(tmp_path, device, probe):
    raw = ["--supervise", "--supervise_wedge_secs", "123", "--data",
           "synthetic", "--supervise_max_recoveries", "4", "--epoch", "9",
           "--device", device, "--ckpt_root", str(tmp_path),
           "--save_path", "m1"]
    ns = tmain.parse_args(raw)
    sup = sup_mod.build_supervisor(ns, raw)
    assert sup.argv == [sys.executable, "-m", "sagnn_tpu_torch.main",
                        "--data", "synthetic", "--epoch", "9", "--device",
                        device, "--ckpt_root", str(tmp_path),
                        "--save_path", "m1"]
    assert sup.resume_args == ["--load_model", "m1"]
    assert (sup.wedge_secs, sup.max_recoveries) == (123.0, 4)
    assert sup.ckpt_dir == os.path.join(str(tmp_path), "m1")
    assert sup.log_path == os.path.join(str(tmp_path), "m1", "train.log")
    assert (sup.relay_probe is not None) == probe
    assert sup.env["PYTHONPATH"].split(os.pathsep)[0] == ROOT
    # on the card the child's host waits block (C1), on the CPU nothing
    assert (sup.env.get(sup_mod.BLOCKING_SYNC_ENV) == "1") == probe


def test_supervised_child_sets_blocking_sync_first(tmp_path, monkeypatch):
    """A child started with BLOCKING_SYNC_ENV calls set_blocking_sync
    before anything else touches a device, and stops if it fails."""
    from sagnn_tpu_torch import device as dev_mod

    def refuse():
        raise RuntimeError("scheduling flags not set")

    monkeypatch.setattr(dev_mod, "set_blocking_sync", refuse)
    monkeypatch.setenv(sup_mod.BLOCKING_SYNC_ENV, "1")
    with pytest.raises(RuntimeError, match="scheduling flags"):
        tmain.main(["--data", "synthetic", "--ckpt_root", str(tmp_path)])
    assert not (tmp_path / "tem").exists()


def test_main_supervise_passes_the_raw_arguments(tmp_path, monkeypatch):
    """main(argv) hands its own argument list to the supervisor with the
    preset's save_path; the supervisor process starts no training."""
    seen = {}

    def fake(ns, raw):
        seen.update(save_path=ns.save_path, raw=list(raw))
        return 7

    monkeypatch.setattr(sup_mod, "supervise_main", fake)
    raw = ["--data", "gowalla", "--supervise", "--device", "cpu",
           "--ckpt_root", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        tmain.main(raw)
    assert e.value.code == 7
    assert seen == {"save_path": "gowalla", "raw": raw}


def test_supervised_cli_recovers_an_induced_sigstop(tmp_path, monkeypatch):
    """`main --supervise --device cpu` on a tiny synthetic set: the child
    is SIGSTOPped at its first step line, recovered through its
    preemption checkpoint, resumed, and the supervisor exits 0 after one
    recovery. The poll is shortened (the CLI's is 15 s). Only the stopped
    child may read as wedged on a loaded machine: any CPU at all counts as
    busy (cpu_eps 0; a stopped child burns exactly zero), the silent cap
    is off (it is held on synthetic readings), and the child runs one
    thread, which a starved machine cannot stall at a barrier."""
    built = []

    def quick(ns, raw):
        sup = build(ns, raw)
        sup.check_every, sup.cpu_eps, sup.silent_cap_secs = 0.25, 0.0, 0.0
        sup.env = dict(sup.env, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        built.append(sup)
        return sup

    build = sup_mod.build_supervisor
    monkeypatch.setattr(sup_mod, "build_supervisor", quick)
    raw = ["--data", "synthetic", "--device", "cpu", "--synth_users", "48",
           "--synth_items", "64", "--graphNum", "2", "--epoch", "2",
           "--trnNum", "64", "--batch", "16", "--testSize", "8",
           "--sslNum", "3", "--sampNum", "4", "--latdim", "16",
           "--num_attention_heads", "4", "--ssldim", "8", "--pos_length",
           "10", "--att_layer", "1", "--tstEpoch", "1", "--spmm_backend",
           "pallas", "--ckpt_root", str(tmp_path), "--save_path", "sv",
           "--supervise", "--supervise_wedge_secs", "3"]
    log = tmp_path / "sv" / "train.log"
    stopped = []

    def drill():
        deadline = time.time() + 120
        while time.time() < deadline and not stopped:
            time.sleep(0.05)
            pids = [re.search(r"launched pid (\d+)", e)
                    for e in (built[0].events if built else [])]
            pids = [int(m.group(1)) for m in pids if m]
            if pids and log.exists() and "Step " in log.read_text():
                os.kill(pids[0], signal.SIGSTOP)
                stopped.append(pids[0])

    th = threading.Thread(target=drill, daemon=True)
    th.start()
    out = {}

    def run():
        try:
            tmain.main(raw)
        except SystemExit as e:
            out["rc"] = e.code

    runner = threading.Thread(target=run, daemon=True)
    runner.start()
    runner.join(240)
    th.join(5)
    events = "\n".join(built[0].events) if built else "no supervisor"
    tail = log.read_text()[-3000:] if log.exists() else "no log"
    why = f"events:\n{events}\ntrain.log:\n{tail}"
    assert not runner.is_alive(), f"supervised run did not finish; {why}"
    assert stopped and out["rc"] == 0, why
    sup = built[0]
    assert sup.recoveries == 1, why
    text = log.read_text()
    assert "WEDGE" in "\n".join(sup.events)
    assert "writing preemption checkpoint" in text
    assert "Model Loaded, resuming at epoch" in text
    assert ", max: " in text
    assert not [f for f in os.listdir(tmp_path / "sv") if ".tmp" in f]
