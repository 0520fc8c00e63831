"""Training-run supervisor: keep a long training run of the port alive.

    python -m stereo_rcnn_tpu_torch.tools.supervise_train \
        --ckpt-dir runs/exp0 -- --synthetic 504 --ckpt-dir runs/exp0 \
        --config cfg.json --ckpt-every 16

Port of the JAX package's ``tools/supervise_train.py`` without its
TPU-backend-wedge handling.  It runs ``python -m
stereo_rcnn_tpu_torch.tools.train`` with everything after ``--``
(``--resume`` appended; the trainer ignores it while no checkpoint
exists), and:

- declares the run stalled when neither its output nor any file under
  the checkpoint directory or ``runs/synth_pool_torch/`` has changed for
  ``--stall-timeout`` seconds, and kills it by process group (SIGTERM,
  which the trainer answers with a checkpoint, then SIGKILL after
  ``--term-grace``);
- relaunches it with ``--resume``: at once after a preemption exit
  (``PREEMPTED_RC``, 75), else after a backoff that doubles up to 15
  minutes;
- stops when a run exits 0, after ``--max-attempts``, or after
  ``--max-hours``.

The child runs in the current directory (as the trainer's relative
paths, such as its pool cache, expect).
"""

from __future__ import annotations

import argparse
import os
import select
import signal
import subprocess
import sys
import time

from stereo_rcnn_tpu_torch.tools.train import POOL_DIR, PREEMPTED_RC


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint dir of the supervised run (watched for "
                        "activity; must match the --ckpt-dir passed to the "
                        "trainer after --)")
    p.add_argument("--stall-timeout", type=float, default=1800.0,
                   help="seconds without child output or file activity "
                        "before the child is declared stalled and killed")
    p.add_argument("--max-attempts", type=int, default=20)
    p.add_argument("--backoff", type=float, default=60.0,
                   help="initial retry backoff (doubles up to 15 min)")
    p.add_argument("--max-hours", type=float, default=0.0,
                   help="give up after this many hours total (0 = no cap)")
    p.add_argument("--term-grace", type=float, default=600.0,
                   help="seconds to wait after SIGTERM before SIGKILL; "
                        "must cover the trainer's preemption checkpoint")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="-- then arguments for the trainer")
    args = p.parse_args(argv)
    if args.train_args and args.train_args[0] == "--":
        args.train_args = args.train_args[1:]
    if not args.train_args:
        p.error("pass the trainer's arguments after --")
    return args


def _newest_mtime(path: str) -> float:
    newest = 0.0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                newest = max(newest, os.path.getmtime(os.path.join(root, f)))
            except OSError:
                pass
    return newest


def _kill_tree(proc: subprocess.Popen, term_grace: float = 600.0) -> None:
    """Kill the child's process group by pgid, never by name: SIGTERM
    first, with a grace that covers the trainer's checkpoint, then
    SIGKILL."""
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    for sig, grace in ((signal.SIGTERM, term_grace),
                       (signal.SIGKILL, 30.0)):
        try:
            os.killpg(pgid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=grace)
            return
        except subprocess.TimeoutExpired:
            continue


def run_attempt(args, attempt: int) -> int:
    """One supervised trainer run.  Returns the child's exit code, or -1
    if it was killed for stalling."""
    cmd = [sys.executable, "-m", "stereo_rcnn_tpu_torch.tools.train",
           *args.train_args]
    if "--resume" not in cmd:
        cmd.append("--resume")
    print(f"[supervise] attempt {attempt}: {' '.join(cmd)}", flush=True)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1, start_new_session=True)
    watch = [POOL_DIR, args.ckpt_dir]
    last_activity = time.time()
    try:
        while True:
            ready, _, _ = select.select([proc.stdout], [], [], 30.0)
            if ready:
                line = proc.stdout.readline()
                if line:
                    sys.stdout.write(line)
                    sys.stdout.flush()
                    last_activity = time.time()
                    continue
                return proc.wait()          # EOF: the child exited
            file_act = max((_newest_mtime(w) for w in watch
                            if os.path.isdir(w)), default=0.0)
            last_activity = max(last_activity, file_act)
            if time.time() - last_activity > args.stall_timeout:
                print(f"[supervise] no activity for "
                      f"{args.stall_timeout:.0f}s — killing pid "
                      f"{proc.pid}", flush=True)
                _kill_tree(proc, args.term_grace)
                return -1
    finally:
        if proc.poll() is None:
            _kill_tree(proc, args.term_grace)
        proc.stdout.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    t0 = time.time()
    backoff = args.backoff
    for attempt in range(1, args.max_attempts + 1):
        rc = run_attempt(args, attempt)
        if rc == 0:
            print(f"[supervise] training completed "
                  f"(total {(time.time() - t0) / 3600:.2f} h)", flush=True)
            return 0
        if args.max_hours and (time.time() - t0) > args.max_hours * 3600:
            print("[supervise] time budget exhausted; giving up", flush=True)
            return 2
        if rc == PREEMPTED_RC:
            # Preempted after a saved checkpoint: resume at once and reset
            # the backoff (not a crash).
            print(f"[supervise] attempt {attempt} preempted with a saved "
                  f"checkpoint; resuming immediately", flush=True)
            backoff = args.backoff
            continue
        print(f"[supervise] attempt {attempt} ended rc={rc}; retrying in "
              f"{backoff:.0f}s", flush=True)
        time.sleep(backoff)
        backoff = min(backoff * 2, 900.0)
    print("[supervise] max attempts exhausted", flush=True)
    return 2


if __name__ == "__main__":
    sys.exit(main())
