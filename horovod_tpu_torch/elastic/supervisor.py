"""Supervised elastic relaunch (``hvdrun-torch --elastic --max-restarts
N``) and the stale-heartbeat watchdog: the port of
``horovod_tpu.elastic.supervisor``.

The launcher's fail-fast kill-all is the right *teardown*; this module
adds the right *recovery*: classify the incident from the trigger
worker's exit code (:func:`horovod_tpu_torch.run.driver.classify_exit`),
tear the world down, and relaunch. Workers find the latest resume
manifest on disk (:mod:`horovod_tpu_torch.elastic.snapshot`) and continue
from the last committed snapshot — so a preempted or crashed rank costs
at most one snapshot cadence of recomputation, not the run.

Per-incident policy:

* ``clean``     -> done, exit 0
* ``usage``     -> exit 2 immediately (deterministic; reruns identically)
* ``preempted`` -> relaunch without consuming the restart budget
  (``count_preemptions=True`` restores strict budgeting). With ``min_np``
  below the current world, the relaunch SHRINKS to the surviving ranks.
* ``crashed``   -> relaunch at the same size, consuming one restart
* ``stalled``   -> a worker the health watchdog killed for a stale
  heartbeat; relaunch consuming one restart
* ``resized``   -> the worker drained + snapshotted and exited
  ``EXIT_RESIZED`` on purpose (the ``resize:`` fault action); relaunch
  FREE at the size the fault plan requested — both sides parse
  ``HOROVOD_FAULT_PLAN``, so the requested size needs no side channel.

Growth: ``capacity_fn`` (CLI: ``--slots-file``) reports how many worker
slots the fleet can field; each relaunch clamps to
``min(capacity, max_np)``, so a shrunken world grows back. An explicit
``resize:`` request is never second-guessed.

Health watchdog: workers touch a per-rank heartbeat at every window
boundary (:class:`~horovod_tpu_torch.elastic.signals.Heartbeat`; the
supervisor exports ``HOROVOD_HEARTBEAT_DIR``, a directory namespaced per
supervisor and removed at its end); the :class:`HealthWatchdog` rides
:func:`horovod_tpu_torch.run.launch_job`'s supervision poll and
SIGKILLs any rank silent past ``watchdog_timeout``. The serving fleet
(:mod:`~horovod_tpu_torch.serve.fleet`) uses the same watchdog over its
replicas.

Each attempt exports ``HOROVOD_ELASTIC=1`` and
``HOROVOD_ELASTIC_RESTART=<attempt>``. The JAX package's
``jax_distributed`` argument has no counterpart: the launcher sets every
rank's ``RANK``/``WORLD_SIZE``/``MASTER_*`` itself.

Recovery metrics: ``metrics_path`` (CLI ``--metrics-file``) gets one
JSON line in the reference's ``PERF_RUNS.tsv`` format — restarts by exit
class, the world-size trajectory, time-to-detect and time-to-relaunch.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from horovod_tpu_torch.run import launch_job
from horovod_tpu_torch.run.driver import EXIT_USAGE, classify_exit


def _log(msg: str) -> None:
    print(f"hvdrun-torch[elastic]: {msg}", file=sys.stderr, flush=True)


class HealthWatchdog:
    """Supervisor-side stale-heartbeat detector.

    :meth:`check` stats the per-rank heartbeat files (throttled to
    ``interval`` so the caller's poll loop stays cheap) and returns the
    ranks whose last beat is older than ``timeout``; the caller SIGKILLs
    them — the only safe recovery for a silently-stalled worker — and
    marks their :class:`~horovod_tpu_torch.run.driver.WorkerExit`
    *stalled* so policy and metrics see the real class. A rank is only
    watched once its heartbeat file exists. ``timeout`` must exceed the
    slowest interval between two beats (for a fleet: a whole tick,
    relaunch captures included). ``kills`` records the age observed at
    each kill decision; the owner clears a rank's entry when it
    relaunches it.
    """

    def __init__(self, directory: str, timeout: float,
                 interval: float = 0.5, _now=time.monotonic):
        from horovod_tpu_torch.elastic.signals import Heartbeat

        self.directory = directory
        self.timeout = float(timeout)
        self.interval = float(interval)
        self._now = _now
        self._fmt = Heartbeat.FILE_FMT
        self._last_check = -float("inf")
        #: rank -> observed heartbeat age (secs) at the kill decision.
        self.kills: Dict[int, float] = {}

    def reset(self) -> None:
        """Per-attempt reset (the supervisor also clears the heartbeat
        files themselves so attempt N's silence is never judged by
        attempt N-1's mtimes)."""
        self.kills.clear()
        self._last_check = -float("inf")

    def check(self, ranks: Sequence[int]) -> Dict[int, float]:
        """Stale ranks among ``ranks`` -> heartbeat age. Throttled:
        returns {} between ``interval`` ticks."""
        now = self._now()
        if now - self._last_check < self.interval:
            return {}
        self._last_check = now
        wall = time.time()
        stale = {}
        for rank in ranks:
            if rank in self.kills:
                continue
            path = os.path.join(self.directory,
                                self._fmt.format(rank=rank))
            try:
                age = wall - os.stat(path).st_mtime
            except OSError:
                continue  # no beat yet: not watched
            if age > self.timeout:
                stale[rank] = age
        return stale


def _resolve_watchdog_timeout(value: Optional[float]) -> float:
    from horovod_tpu_torch.common.config import (
        DEFAULT_WATCHDOG_TIMEOUT_SECS, _env_float)

    if value is not None:
        return float(value)
    return _env_float("HOROVOD_WATCHDOG_TIMEOUT",
                      DEFAULT_WATCHDOG_TIMEOUT_SECS)


def slots_file_capacity(path: str) -> Callable[[], Optional[int]]:
    """A ``capacity_fn`` reading currently-available worker slots from
    a file (one integer) an external scheduler/agent keeps current —
    the CI-testable stand-in for real host discovery. Missing or
    malformed file -> None (capacity unknown; the supervisor keeps its
    current size)."""

    def capacity() -> Optional[int]:
        try:
            with open(path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    return capacity


def _write_metrics(path: str, lane: str, record: dict) -> None:
    stamp = datetime.datetime.now(datetime.timezone.utc).isoformat()
    line = f"{stamp}\t{lane}\t{json.dumps(record, sort_keys=True)}\n"
    with open(path, "a") as f:
        f.write(line)


def supervise(cmd: Sequence[str], np: int,
              hosts: Optional[str] = None,
              env: Optional[Dict[str, str]] = None,
              max_restarts: int = 1,
              restart_delay: float = 0.0,
              count_preemptions: bool = False,
              max_total_attempts: int = 1000,
              min_np: Optional[int] = None,
              max_np: Optional[int] = None,
              capacity_fn: Optional[Callable[[], Optional[int]]] = None,
              watchdog_timeout: Optional[float] = None,
              heartbeat_dir: Optional[str] = None,
              metrics_path: Optional[str] = None,
              metrics_lane: str = "elastic_supervise",
              _launch=launch_job) -> int:
    """Run ``cmd`` elastically; returns the final job exit code.

    ``max_restarts`` bounds crash/stall-triggered relaunches;
    preemptions and resizes relaunch for free unless
    ``count_preemptions`` (with ``max_total_attempts`` as the runaway
    backstop either way). ``min_np``/``max_np`` (default: ``np`` — a
    fixed world) bound the elastic world;
    ``capacity_fn`` reports available slots for regrowth;
    ``watchdog_timeout`` (0 disables) arms the stale-heartbeat
    watchdog. ``_launch`` is injectable for tests.
    """
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    min_np = np if min_np is None else int(min_np)
    max_np = np if max_np is None else int(max_np)
    if not 1 <= min_np <= np <= max_np:
        raise ValueError(
            f"world bounds must satisfy 1 <= min_np ({min_np}) <= np "
            f"({np}) <= max_np ({max_np})")
    base_env = dict(env if env is not None else os.environ)

    from horovod_tpu_torch.elastic.faults import parse_fault_plan, \
        resize_requests

    resize_plan = resize_requests(
        parse_fault_plan(base_env.get("HOROVOD_FAULT_PLAN", "")))
    for a, n in resize_plan.items():
        if not min_np <= n <= max_np:
            raise ValueError(
                f"fault plan resize n={n} (attempt {a}) is outside the "
                f"elastic world bounds [{min_np}, {max_np}]; widen "
                "--min-np/--max-np or fix the plan")

    timeout = _resolve_watchdog_timeout(watchdog_timeout)
    watchdog = None
    if timeout > 0:
        from horovod_tpu_torch.elastic.signals import \
            namespaced_heartbeat_dir

        # Namespaced per supervisor INSTANCE (a unique subdir even when
        # the caller passes a shared base): two supervisors — or a
        # training job and a serving fleet — on one host must never
        # watch each other's hb-<rank> files, where a foreign rank 0's
        # touches would keep a stalled local rank 0 "alive" forever.
        heartbeat_dir = namespaced_heartbeat_dir(heartbeat_dir)
        base_env["HOROVOD_HEARTBEAT_DIR"] = heartbeat_dir
        watchdog = HealthWatchdog(heartbeat_dir, timeout)
    else:
        # Watchdog disabled: drop any INHERITED heartbeat dir so this
        # job's workers don't feed an outer supervisor's watchdog (a
        # stalled outer rank sharing our rank id would look alive).
        base_env.pop("HOROVOD_HEARTBEAT_DIR", None)

    def _clamp(n: int) -> int:
        return max(min_np, min(max_np, n))

    restarts_used = 0
    attempt = 0
    np_cur = np
    world_trajectory = [np_cur]
    restarts_by_class: Dict[str, int] = {}
    detect_secs: List[float] = []
    relaunch_secs: List[float] = []
    t_job = time.monotonic()
    # None until a real outcome: an exception unwinding the loop must
    # not stamp the metrics record as a clean exit.
    final_code: Optional[int] = None
    t_incident: Optional[float] = None
    try:
        while True:
            if watchdog is not None:
                watchdog.reset()
                # Only the hb-* files this module owns: attempt N must
                # not be judged by attempt N-1's mtimes, but a caller-
                # provided directory may hold unrelated files.
                for name in os.listdir(heartbeat_dir):
                    if not name.startswith("hb-"):
                        continue
                    try:
                        os.unlink(os.path.join(heartbeat_dir, name))
                    except OSError:
                        pass
            wenv = dict(base_env)
            wenv["HOROVOD_ELASTIC"] = "1"
            wenv["HOROVOD_ELASTIC_RESTART"] = str(attempt)
            if t_incident is not None:
                # Supervisor-side relaunch turnaround: incident return
                # -> the relaunch is handed to the launcher (policy +
                # heartbeat cleanup + restart_delay).
                relaunch_secs.append(time.monotonic() - t_incident)
                t_incident = None
            result = _launch(cmd, np=np_cur, hosts=hosts, env=wenv,
                             watchdog=watchdog)
            category = result.category
            if category == "clean":
                if attempt:
                    _log(f"job completed after {attempt} relaunch(es) "
                         f"(world trajectory {world_trajectory})")
                final_code = 0
                return 0
            if category == "usage":
                # Exit code 2 reruns identically (bad flags, import-time
                # misuse); burning the budget only delays the real error.
                _log(f"{result.describe()} — deterministic usage error, "
                     "not relaunching")
                final_code = EXIT_USAGE
                return EXIT_USAGE
            restarts_by_class[category] = \
                restarts_by_class.get(category, 0) + 1
            detect_secs.extend(result.stalled_ranks.values())
            consumes = category in ("crashed", "stalled") \
                or (count_preemptions and category in ("preempted",
                                                       "resized"))
            budget_left = max_restarts - restarts_used
            if (consumes and budget_left <= 0) \
                    or attempt + 1 >= max_total_attempts:
                _log(f"{result.describe()} — restart budget exhausted "
                     f"({restarts_used}/{max_restarts} used); giving up")
                final_code = result.code
                return result.code
            if consumes:
                restarts_used += 1

            # ---- world-size policy for the next attempt -------------
            t_incident = time.monotonic()
            np_next = np_cur
            if category == "resized":
                requested = resize_plan.get(attempt)
                if requested is None:
                    _log("EXIT_RESIZED with no resize clause armed for "
                         f"attempt {attempt}; keeping world {np_cur}")
                else:
                    np_next = _clamp(requested)
            elif category == "preempted" and min_np < np_cur:
                # Shrink to the SURVIVORS: every rank that exited on
                # its own before the kill-all was reclaimed (a whole
                # lost host shows up as several preempted pre-kill
                # codes in one poll), and none of them are coming
                # back. (Crashes/stalls keep the size — the host is
                # still there, the process was the problem.)
                lost = max(1, sum(
                    1 for c in result.pre_kill_codes.values()
                    if classify_exit(c) == "preempted"))
                np_next = _clamp(np_cur - lost)
            if capacity_fn is not None and category != "resized":
                # Capacity is the fleet's truth: grow back toward
                # max_np when it returns, shrink below the policy size
                # when even that is gone. An explicit resize: request
                # is never second-guessed — it was validated against
                # the bounds at launch.
                available = capacity_fn()
                if available is not None:
                    np_next = _clamp(min(available, max_np))
            attempt += 1
            if np_next != np_cur:
                _log(f"{result.describe()} — resizing world "
                     f"{np_cur} -> {np_next} and relaunching from the "
                     f"latest snapshot (attempt {attempt}; "
                     f"{max_restarts - restarts_used} crash restart(s) "
                     "left)")
                np_cur = np_next
                world_trajectory.append(np_cur)
            else:
                _log(f"{result.describe()} — relaunching all "
                     f"{np_cur} rank(s) from the latest snapshot "
                     f"(attempt {attempt}; "
                     f"{max_restarts - restarts_used} crash restart(s) "
                     "left)")
            if restart_delay > 0:
                # ssh-remote teardown is asynchronous (pty HUP): let it
                # settle before the relaunch contends for devices.
                time.sleep(restart_delay)
    finally:
        if watchdog is not None:
            # The namespaced heartbeat dir is THIS supervise() call's
            # own (unique by construction): remove it, or a long-lived
            # service looping over supervise() accumulates one orphan
            # dir of stale hb-<rank> files per invocation forever.
            import shutil

            shutil.rmtree(heartbeat_dir, ignore_errors=True)
        if metrics_path:
            record = {
                "metric": "elastic_recovery",
                "value": attempt,
                "unit": "relaunches",
                "elastic": {
                    "attempts": attempt + 1,
                    "restarts_by_class": restarts_by_class,
                    "world": world_trajectory,
                    "final_np": np_cur,
                    "min_np": min_np,
                    "max_np": max_np,
                    "detect_s": round(max(detect_secs), 2)
                    if detect_secs else None,
                    "relaunch_s": round(
                        sum(relaunch_secs) / len(relaunch_secs), 3)
                    if relaunch_secs else None,
                    "wall_s": round(time.monotonic() - t_job, 2),
                    "exit_code": final_code,
                },
            }
            try:
                _write_metrics(metrics_path, metrics_lane, record)
            except OSError as e:
                _log(f"could not write recovery metrics to "
                     f"{metrics_path}: {e}")


__all__ = ["supervise", "HealthWatchdog", "slots_file_capacity"]
