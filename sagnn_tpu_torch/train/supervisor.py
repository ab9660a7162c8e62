"""Wedge watchdog: failure detection and automatic recovery of a training
run; the port of `sagnn_tpu/train/supervisor.py`.

A supervisor process launches the training run as a child, watches it,
and runs the recovery sequence when the child wedges or crashes.

Detection criterion: a wedged run shows BOTH no new log output AND ~zero
child CPU over a sustained window. Either signal alone is normal: a
full-sort evaluation or a large checkpoint write is log-silent but burns
CPU; a long device step is CPU-quiet but logs when it ends. So only the
conjunction, held for `wedge_secs`, declares a wedge. Two more rules, as
in the JAX package: before the child's first log line the window is at
least `startup_grace` (a fresh interpreter can be starved before it even
installs its SIGTERM handler), and `silent_cap_secs` of log silence alone
declares a wedge whatever the CPU does (a permanent hang whose threads
keep trickling CPU). `_decide` holds this criterion: one poll's readings
in, the next watch state and a wedge reason out.

Where this differs from the JAX package's supervisor, and why:
  * A host thread waiting on the card spin-waits by default, at about a
    core, so a child blocked on a hung CUDA call never looks idle. The
    child of `main --supervise` on the card therefore sets
    `cudaDeviceScheduleBlockingSync` before its first CUDA call
    (`device.set_blocking_sync`, asked for through `BLOCKING_SYNC_ENV`;
    it stops with an error if the flag does not take): its waits sleep,
    and the no-CPU conjunction sees the hang.
  * JAX counts the silent cap only once the child has logged, so a child
    that hangs before its first line (a relaunch stuck in device
    initialisation, say) is never declared when it keeps burning CPU.
    Here the cap also runs before the first line, from the spawn, at
    max(silent_cap_secs, startup_grace).
  * When the recovery budget is spent, the child is stopped and its
    checkpoint's staging files are removed before giving up, as a
    recovery would remove them.

Recovery sequence:
  1. SIGCONT + SIGTERM the exact child pid. The Trainer's preemption
     handler (`Trainer.install_preemption_handler`) writes a checkpoint
     and exits (a stopped child cannot run its handler, hence SIGCONT).
  2. Bounded wait for exit, watching the sidecar mtimes so the save gets
     time to land; then SIGKILL.
  3. Remove the checkpoint's staging files (`state.tmp`, `*.json.tmp`,
     `train/checkpoint.py`), never `state` or a committed sidecar.
  4. Probe the card with a tiny CUDA op in a fresh process; retry with
     backoff.
  5. Relaunch the run with `--load_model <save_path>`: the resume
     re-enters the interrupted epoch with the same batches.

Used through `python -m sagnn_tpu_torch.main --supervise ...`
(`supervise_main` re-execs the command line without the supervisor's
flags as the child) or programmatically with any child argv. This module
starts no device work itself.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# set to "1" in the environment of a supervised child that trains on the
# card: `main` then calls `device.set_blocking_sync` before its first CUDA
# call (module docstring)
BLOCKING_SYNC_ENV = "SAGNN_CUDA_BLOCKING_SYNC"


def _now() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def child_cpu_seconds(pid: int) -> Optional[float]:
    """Cumulative user+system CPU of `pid` (all threads), from /proc.
    None once the process is gone."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode("ascii", "replace")
    except OSError:
        return None
    # comm may contain spaces/parens: fields start after the LAST ')'
    fields = raw[raw.rfind(")") + 2:].split()
    utime, stime = int(fields[11]), int(fields[12])  # fields 14,15 (1-based)
    hz = os.sysconf("SC_CLK_TCK")
    return (utime + stime) / hz


@dataclass(frozen=True)
class Watch:
    """What detection remembers between polls of one child."""

    last_size: int                      # log size at the last poll
    last_cpu: float                     # child CPU seconds at the last poll
    quiet_since: Optional[float] = None   # start of no-log, no-CPU window
    cpu_at_quiet: float = 0.0           # child CPU at quiet_since
    silent_since: Optional[float] = None  # the spawn, then the last log
    #                                       growth
    armed: bool = False                 # the child has logged since launch


@dataclass
class Supervisor:
    """Launches `argv` as a supervised child and auto-recovers wedges.

    argv:          the training command (e.g. [sys.executable, "-m",
                   "sagnn_tpu_torch.main", ...])
    log_path:      child stdout+stderr are appended here; its growth is the
                   progress signal
    ckpt_dir:      the run's checkpoint directory (<ckpt_root>/<save_path>);
                   staging files under it are cleaned on recovery
    resume_args:   appended to argv on every relaunch (e.g.
                   ["--load_model", "gowalla"]) unless already present
    check_every:   poll period, seconds
    wedge_secs:    how long the (no-log AND no-CPU) conjunction must hold
    cpu_eps:       total CPU seconds over the quiet window below which the
                   child counts as idle ("~zero CPU")
    term_grace:    max seconds between SIGTERM and SIGKILL
    commit_settle: after a sidecar commit is observed post-SIGTERM, wait
                   this long for further disk writes before SIGKILL
    startup_grace: the least quiet window before the child's first log
                   output after a (re)launch
    silent_cap_secs: log silence that declares a wedge whatever the CPU
                   does; None = 6 x wedge_secs, <= 0 disables. Before the
                   child's first output the cap runs from the spawn and is
                   max(silent_cap_secs, startup_grace)
    max_recoveries: give up after this many recoveries (0 = unlimited)
    relay_probe:   argv probing the card in a fresh process (None skips it,
                   as a CPU run does); must exit 0 when healthy
    """

    argv: Sequence[str]
    log_path: str
    ckpt_dir: Optional[str] = None
    resume_args: Sequence[str] = ()
    check_every: float = 15.0
    wedge_secs: float = 300.0
    cpu_eps: float = 2.0
    term_grace: float = 300.0
    commit_settle: float = 15.0
    startup_grace: float = 60.0
    silent_cap_secs: Optional[float] = None
    max_recoveries: int = 8
    relay_probe: Optional[Sequence[str]] = (
        sys.executable, "-c",
        "import torch; torch.ones(1, device='cuda').sum().item()")
    relay_probe_timeout: float = 180.0
    env: Optional[dict] = None

    events: List[str] = field(default_factory=list, init=False)
    recoveries: int = field(default=0, init=False)

    # -- logging ----------------------------------------------------------

    def _say(self, msg: str) -> None:
        line = f"{_now()}: [supervisor] {msg}"
        self.events.append(line)
        print(line, file=sys.stderr, flush=True)

    # -- child lifecycle --------------------------------------------------

    def _spawn(self, resume: bool) -> subprocess.Popen:
        argv = list(self.argv)
        if resume and self.resume_args and self.resume_args[0] not in argv:
            argv += list(self.resume_args)
        env = dict(os.environ if self.env is None else self.env)
        env.setdefault("PYTHONUNBUFFERED", "1")  # log growth IS the signal
        with open(self.log_path, "ab", buffering=0) as logf:
            # its own process group: the signals reach the exact pid
            child = subprocess.Popen(
                argv, stdout=logf, stderr=subprocess.STDOUT, env=env,
                start_new_session=True)
        self._say(f"launched pid {child.pid}: {' '.join(map(str, argv))}")
        return child

    def _log_size(self) -> int:
        try:
            return os.stat(self.log_path).st_size
        except OSError:
            return 0

    def _sidecar_mtime(self) -> float:
        """Newest mtime of the checkpoint's sidecars (history/config/rng),
        the observable of a save landing on disk."""
        if not self.ckpt_dir:
            return 0.0
        newest = 0.0
        for name in ("history.json", "config.json", "rng.json"):
            try:
                newest = max(newest,
                             os.stat(os.path.join(self.ckpt_dir, name))
                             .st_mtime)
            except OSError:
                pass
        return newest

    def _terminate(self, child: subprocess.Popen) -> None:
        """SIGCONT+SIGTERM -> bounded wait (letting the preemption handler
        save) -> SIGKILL."""
        t_term = time.time()
        try:
            os.kill(child.pid, signal.SIGCONT)  # a SIGSTOPped child cannot
            os.kill(child.pid, signal.SIGTERM)  # run its SIGTERM handler
        except ProcessLookupError:
            return
        self._say(f"sent SIGCONT+SIGTERM to pid {child.pid}; waiting up to "
                  f"{self.term_grace:.0f}s for the preemption handler")
        committed_at = None
        size_at_term = self._log_size()
        polls = 0
        while time.time() - t_term < self.term_grace:
            if child.poll() is not None:
                self._say(f"child exited rc={child.returncode} after SIGTERM")
                return
            if self._sidecar_mtime() >= t_term:
                committed_at = committed_at or time.time()
                # save observed: give trailing writes a moment, then stop
                # waiting on a handler that may hang after it
                if time.time() - committed_at >= self.commit_settle:
                    self._say("sidecar commit observed after SIGTERM; not "
                              "waiting out the preemption save")
                    break
            time.sleep(1.0)
            # Re-CONT every poll: a SIGTERM that lands exactly as a stopped
            # child resumes can leave the interpreter's pending-signal flag
            # set while the in-flight call re-stops the process before any
            # bytecode boundary, and a periodic SIGCONT (ignored by a
            # running child) unsticks it within 1 s. A handler that shows
            # no sign of life (no log output, no sidecar) gets SIGTERM again
            # now and then; one that is alive never does, since a second
            # delivery would re-enter its save.
            polls += 1
            try:
                os.kill(child.pid, signal.SIGCONT)
                if (polls % 5 == 0 and committed_at is None
                        and self._log_size() == size_at_term):
                    os.kill(child.pid, signal.SIGTERM)
                    self._say("re-sent SIGTERM (handler silent)")
            except ProcessLookupError:
                pass
        try:
            os.kill(child.pid, signal.SIGKILL)
            self._say(f"SIGKILL pid {child.pid}")
        except ProcessLookupError:
            pass
        child.wait()

    def _clean_tmp(self) -> None:
        """Remove the checkpoint's staging files (`state.tmp`,
        `*.json.tmp`): a save cut off mid-write leaves them, and they are
        files, not directories as JAX's orbax staging is. Never `state`
        or a committed sidecar."""
        if not self.ckpt_dir:
            return
        for p in sorted(glob.glob(os.path.join(self.ckpt_dir, "state.tmp"))
                        + glob.glob(os.path.join(self.ckpt_dir,
                                                 "*.json.tmp"))):
            self._say(f"removing partial checkpoint staging file {p}")
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def _probe_relay(self) -> bool:
        """Run `relay_probe` until it exits 0 (five tries, with backoff)."""
        if self.relay_probe is None:
            return True
        for attempt in range(5):
            try:
                r = subprocess.run(list(self.relay_probe),
                                   capture_output=True,
                                   timeout=self.relay_probe_timeout)
                if r.returncode == 0:
                    self._say(f"relay probe ok (attempt {attempt + 1})")
                    return True
                self._say(f"relay probe rc={r.returncode}: "
                          f"{r.stderr[-200:].decode(errors='replace')}")
            except subprocess.TimeoutExpired:
                self._say("relay probe timed out")
            time.sleep(15.0 * (attempt + 1))
        return False

    # -- detection --------------------------------------------------------

    def _launch(self, resume: bool) -> Tuple[subprocess.Popen, Watch]:
        """Spawn the child and start watching it from the log's size
        before the spawn, so that output the child makes at once counts
        as its first output."""
        size = self._log_size()
        spawned = time.time()
        child = self._spawn(resume)
        return child, Watch(last_size=size,
                            last_cpu=child_cpu_seconds(child.pid) or 0.0,
                            silent_since=spawned)

    def _decide(self, w: Watch, size: int, cpu: Optional[float],
                now: float) -> Tuple[Watch, Optional[str]]:
        """One poll: the log size, the child's CPU seconds (None once it
        is gone) and the time, against the watch state. Returns the next
        state and the wedge's reason, or None while the child is not
        wedged. No side effects."""
        silent_cap = (6.0 * self.wedge_secs if self.silent_cap_secs is None
                      else self.silent_cap_secs)
        cpu = w.last_cpu if cpu is None else cpu
        if size != w.last_size:
            return Watch(last_size=size, last_cpu=cpu, armed=True), None
        quiet_since, cpu_at_quiet = w.quiet_since, w.cpu_at_quiet
        silent_since = now if w.silent_since is None else w.silent_since
        wedged = None
        if quiet_since is None:
            quiet_since, cpu_at_quiet = now, cpu
        elif cpu - cpu_at_quiet > self.cpu_eps:
            # log-silent but CPU-active (evaluation, a checkpoint write):
            # not a wedge, unless the silent cap below trips
            quiet_since, cpu_at_quiet = now, cpu
        elif now - quiet_since >= (
                self.wedge_secs if w.armed
                else max(self.wedge_secs, self.startup_grace)):
            wedged = (f"WEDGE: no log output and {cpu - cpu_at_quiet:.2f}s "
                      f"CPU over {now - quiet_since:.0f}s")
        if not w.armed and silent_cap > 0:
            silent_cap = max(silent_cap, self.startup_grace)
        if (wedged is None and silent_cap > 0
                and now - silent_since >= silent_cap):
            wedged = (f"WEDGE: log silent {now - silent_since:.0f}s >= "
                      f"silent_cap {silent_cap:.0f}s despite CPU activity")
        return dataclasses.replace(
            w, last_size=size, last_cpu=cpu, quiet_since=quiet_since,
            cpu_at_quiet=cpu_at_quiet, silent_since=silent_since), wedged

    # -- main loop --------------------------------------------------------

    def run(self) -> int:
        """Supervise until the child exits 0 (returns 0), recoveries are
        exhausted, or the relay probe never comes back (returns 1)."""
        child, w = self._launch(resume=False)
        while True:
            time.sleep(self.check_every)
            rc = child.poll()
            if rc is not None:
                if rc == 0:
                    self._say("child exited cleanly (rc=0); done")
                    return 0
                self._say(f"child crashed rc={rc}")
                if not self._recover(child, crashed=True):
                    return 1
            else:
                w, wedged = self._decide(w, self._log_size(),
                                         child_cpu_seconds(child.pid),
                                         time.time())
                if wedged is None:
                    continue
                self._say(f"{wedged} (pid {child.pid})")
                if not self._recover(child, crashed=False):
                    return 1
            child, w = self._launch(resume=True)

    def _recover(self, child: subprocess.Popen, crashed: bool) -> bool:
        self.recoveries += 1
        if self.max_recoveries and self.recoveries > self.max_recoveries:
            self._say(f"recovery budget exhausted "
                      f"({self.max_recoveries}); giving up")
            # don't leave the wedged child holding the card: give its
            # handler one last chance to save, then make sure it dies
            if child.poll() is None:
                self._terminate(child)
            self._clean_tmp()
            return False
        self._say(f"recovery {self.recoveries} begins "
                  f"({'crash' if crashed else 'wedge'})")
        if not crashed:
            self._terminate(child)
        self._clean_tmp()
        if not self._probe_relay():
            self._say("relay never recovered; giving up")
            return False
        self._say("recovery complete; relaunching with resume args")
        return True


def supervise_main(ns, raw_argv: Sequence[str]) -> int:
    """Entry for `python -m sagnn_tpu_torch.main --supervise`: supervise
    the child that `build_supervisor` describes until it is done."""
    return build_supervisor(ns, raw_argv).run()


def build_supervisor(ns, raw_argv: Sequence[str]) -> Supervisor:
    """The Supervisor of `main --supervise`: the same arguments
    (`raw_argv`, without the program name) minus the supervisor's flags
    as the child `python -m sagnn_tpu_torch.main`, with `--load_model
    <save_path>` as the resume args and its log in the checkpoint
    directory. The child finds this package whatever its working
    directory (PYTHONPATH). On the card the child's host waits block
    (BLOCKING_SYNC_ENV, module docstring); with `--device cpu` there is no
    card to probe and no wait to set."""
    drop = {"--supervise"}
    takes_value = {"--supervise_wedge_secs", "--supervise_max_recoveries"}
    child_argv: List[str] = [sys.executable, "-m", "sagnn_tpu_torch.main"]
    it = iter(raw_argv)
    for a in it:
        if a in drop:
            continue
        if a in takes_value:
            next(it, None)
            continue
        child_argv.append(a)
    save_path = ns.save_path or "tem"
    ckpt_dir = os.path.abspath(os.path.join(ns.ckpt_root, save_path))
    os.makedirs(ckpt_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    kw = {}
    if getattr(ns, "device", "cuda").startswith("cpu"):
        kw["relay_probe"] = None
    else:
        env[BLOCKING_SYNC_ENV] = "1"
    return Supervisor(
        argv=child_argv,
        log_path=os.path.join(ckpt_dir, "train.log"),
        ckpt_dir=ckpt_dir,
        resume_args=["--load_model", save_path],
        wedge_secs=ns.supervise_wedge_secs,
        max_recoveries=ns.supervise_max_recoveries,
        env=env,
        **kw,
    )
