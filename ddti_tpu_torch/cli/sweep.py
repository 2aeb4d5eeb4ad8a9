"""Sweep launcher, ported from ``ddti_tpu/cli/sweep.py`` (the reference's
``run.sh`` / ``test.sh``): runs a set of training commands as concurrent
subprocesses with a cap on how many run at once and a minimum stagger
between launches. Each job is an independent run.

Two modes:
  config sweep:  python -m ddti_tpu_torch.cli.sweep --config_dir DIR
                 (every DIR/*/config*.yaml gets a run of
                 ``python -m ddti_tpu_torch.cli.main --config_path ...``
                 with ``--extra``'s flags; the jobs run on the card unless
                 those flags say ``--device cpu``)
  command list:  python -m ddti_tpu_torch.cli.sweep --commands_file cmds.txt

The sweep side of preemption: a job that exits 75 (the training CLI's
graceful SIGTERM shutdown) after writing its ``DDTI_RESUME_HINT`` file is
relaunched with ``--resume --checkpoint_path <hint>`` (see ``run_jobs``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shlex
import subprocess
import sys
import tempfile
import time


PREEMPTED_RC = 75  # EX_TEMPFAIL: cli/main.py's graceful-shutdown code


def _with_resume(cmd, checkpoint_path: str):
    """The job command relaunched as a full resume from ``checkpoint_path``
    (argv list gets flags appended; simple shell strings get them quoted
    on). Returns None for COMPOUND shell lines (pipes/redirects/
    sequencing) — appended flags would attach to the wrong command, so
    those jobs are left preempted rather than resumed wrong."""
    extra = ["--resume", "--checkpoint_path", checkpoint_path]
    if isinstance(cmd, str):
        if re.search(r"[;&|<>`]|\$\(", cmd):
            return None
        return cmd + " " + " ".join(shlex.quote(x) for x in extra)
    return list(cmd) + extra


def _take_hint(path: str) -> str:
    """The checkpoint a preempted job named in its hint file; the file is
    removed (the CLI rewrites it if the job is preempted again)."""
    with open(path) as f:
        ckpt = json.load(f)["checkpoint_path"]
    os.unlink(path)
    return ckpt


def run_jobs(commands: list, max_jobs: int = 3,
             min_gap: float = 1.0, env=None, retries: int = 0,
             max_resumes: int = 5) -> list[int]:
    """Launch commands with a concurrency cap + launch stagger; returns
    return codes in input order. A command is either an argv list (exec'd
    directly) or a string (run through the shell — commands-file lines may
    use redirects/pipes like the reference's run.sh jobs). ``retries``
    re-launches failed jobs up to that many times (simple failure
    recovery; the reference's sweep has none).

    Preemption recovery: every job gets a ``DDTI_RESUME_HINT`` env file;
    a job that exits with code 75 (cli/main.py's graceful SIGTERM
    shutdown) after writing its hint is relaunched — up to
    ``max_resumes`` times — with ``--resume --checkpoint_path <hint>``,
    so a preempted sweep entry continues its epoch budget instead of
    restarting or counting as failed. Exit-75 jobs WITHOUT a hint (not
    our CLI, or the save itself failed) fall through to ``retries``.

    The ``retries`` pass never scratch-restarts a preempted job: exit-75
    jobs are retried WITH resume flags when a hint allows it and left at
    75 otherwise (a scratch relaunch would discard the saved checkpoint
    progress); non-75 failures of a previously-resumed job also retry the
    resumed command, not the original."""
    hints = [tempfile.NamedTemporaryFile(
        mode="w", suffix=".resume.json", delete=False).name
        for _ in commands]
    for h in hints:
        os.unlink(h)  # the CLI creates it only on preemption

    def env_for(i):
        e = dict(env or os.environ)
        e["DDTI_RESUME_HINT"] = hints[i]
        return e

    current = list(commands)
    codes = run_jobs_once(current, max_jobs, min_gap,
                          [env_for(i) for i in range(len(current))])
    for _ in range(max_resumes):
        pre = [i for i, c in enumerate(codes)
               if c == PREEMPTED_RC and os.path.exists(hints[i])]
        if not pre:
            break
        resumable = []
        for i in pre:
            ckpt = _take_hint(hints[i])
            resumed = _with_resume(commands[i], ckpt)
            if resumed is None:
                print(f"[sweep] job {i} preempted but its compound "
                      f"shell line cannot take --resume flags — "
                      f"left at exit 75 (resume manually from "
                      f"{ckpt})")
                continue
            current[i] = resumed
            resumable.append(i)
            print(f"[sweep] job {i} preempted — resuming from {ckpt}")
        if not resumable:
            break
        rcodes = run_jobs_once(
            [current[i] for i in resumable], max_jobs, min_gap,
            [env_for(i) for i in resumable])
        for i, c in zip(resumable, rcodes):
            codes[i] = c
    for _ in range(retries):
        failed = []
        for i, c in enumerate(codes):
            if c == 0:
                continue
            if c == PREEMPTED_RC:
                # retry a preempted job only as a RESUME (scratch
                # relaunch would discard its checkpoint progress)
                if os.path.exists(hints[i]):
                    resumed = _with_resume(commands[i],
                                           _take_hint(hints[i]))
                    if resumed is not None:
                        current[i] = resumed
                        failed.append(i)
                elif current[i] != commands[i]:
                    failed.append(i)  # prior resume flags still apply
            else:
                failed.append(i)
        if not failed:
            break
        retry_codes = run_jobs_once(
            [current[i] for i in failed], max_jobs, min_gap,
            [env_for(i) for i in failed])
        for i, c in zip(failed, retry_codes):
            codes[i] = c
    for h in hints:
        if os.path.exists(h):
            os.unlink(h)
    return codes


def run_jobs_once(commands: list, max_jobs: int = 3, min_gap: float = 1.0,
                  envs: list | None = None) -> list[int]:
    """One launch pass (no retries/resumes): the concurrency-capped,
    staggered runner. ``envs`` optionally gives each job its own env."""
    running: list[tuple[int, subprocess.Popen]] = []
    codes: dict[int, int] = {}
    last_start = 0.0

    def reap(block: bool) -> None:
        while running:
            for i, (idx, p) in enumerate(running):
                rc = p.poll()
                if rc is not None:
                    codes[idx] = rc
                    running.pop(i)
                    break
            else:
                if not block and len(running) < max_jobs:
                    return
                time.sleep(0.2)
                continue
            if not block and len(running) < max_jobs:
                return
        return

    for idx, cmd in enumerate(commands):
        reap(block=False)
        while len(running) >= max_jobs:
            reap(block=False)
            time.sleep(0.2)
        gap = time.time() - last_start
        if gap < min_gap:
            time.sleep(min_gap - gap)
        shown = cmd if isinstance(cmd, str) else " ".join(
            shlex.quote(c) for c in cmd)
        print(f"[{time.strftime('%H:%M:%S')}] RUN  ->  {shown}")
        running.append((idx, subprocess.Popen(
            cmd, env=envs[idx] if envs else None,
            shell=isinstance(cmd, str))))
        last_start = time.time()

    while running:
        reap(block=True)
    return [codes[i] for i in range(len(commands))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_dir", default=None,
                    help="directory of <ModelType>/config*.yaml sweep files")
    ap.add_argument("--commands_file", default=None,
                    help="file with one shell command per line")
    ap.add_argument("--max_jobs", type=int, default=3)
    ap.add_argument("--min_gap", type=float, default=1.0)
    ap.add_argument("--retries", type=int, default=0,
                    help="re-launch failed jobs up to N times")
    ap.add_argument("--max_resumes", type=int, default=5,
                    help="relaunch a gracefully preempted job (exit 75 + "
                         "resume hint) with --resume up to N times")
    ap.add_argument("--extra", default="",
                    help="extra flags appended to every generated command")
    args = ap.parse_args(argv)

    commands: list[list[str]] = []
    if args.config_dir:
        pattern = os.path.join(args.config_dir, "*", "config*.yaml")
        for cfg in sorted(glob.glob(pattern)):
            cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.main",
                   "--config_path", cfg]
            if args.extra:
                cmd += shlex.split(args.extra)
            commands.append(cmd)
    if args.commands_file:
        # lines run through the shell, as documented ("one shell command
        # per line") — redirects/pipes/env prefixes work
        with open(args.commands_file) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#"):
                    commands.append(line)
    if not commands:
        print("nothing to run (pass --config_dir or --commands_file)")
        return 1
    codes = run_jobs(commands, args.max_jobs, args.min_gap,
                     retries=args.retries, max_resumes=args.max_resumes)
    print("All jobs finished.")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
