"""Where a Python program's wall time goes: its main thread's stack,
sampled.

    python -m deeplearning4j_tpu_torch.tools.stack_sample --out S.json \\
        [--interval 0.2] [--match chip_smoke.py ...] [--mark PREFIX] \\
        [--stop-after SECONDS] (SCRIPT | -m MODULE) [ARGS...]
    python -m deeplearning4j_tpu_torch.tools.stack_sample --report S.json

The first form runs SCRIPT (or MODULE) as ``__main__`` in this process,
its arguments as they would be, while a daemon thread reads the main
thread's stack every ``--interval`` seconds (``sys._current_frames``)
and keeps the frames whose file name holds a ``--match`` string (default:
the script's own file, or the module's package), outermost first, each
as ``file:function:line``. It writes ``{"interval", "marks", "samples":
[[seconds, [frame, ...]], ...]}`` to ``--out`` when the program ends, or
after ``--stop-after`` seconds, when it also ends this process with exit
code 0 (for a server that never returns). ``--mark PREFIX`` records in
``marks`` the seconds at which the program first wrote a stdout line
starting with PREFIX (a server's ready line). The program's own exit
code is this process's.

The second form prints the seconds by function (inclusive: a function
counts once a sample however often it recurs) and by innermost frame.

Only the main thread is read: threads and subprocesses the program
starts show as the main thread's wait for them. A sample costs the main
thread one GIL hand-over; the program's own timings are not corrected.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time


class _Sampler:
    def __init__(self, interval, match, out, stop_after=None):
        self.interval, self.match, self.out = interval, tuple(match), out
        self.samples, self.marks = [], {}
        self.t0 = time.perf_counter()
        self._main = threading.main_thread().ident
        self._lock = threading.Lock()
        self._written = False
        threading.Thread(target=self._run, daemon=True,
                         name="stack-sample").start()
        if stop_after is not None:
            threading.Thread(target=self._stop, args=(stop_after,),
                             daemon=True, name="stack-sample-stop").start()

    def now(self) -> float:
        return round(time.perf_counter() - self.t0, 3)

    def _run(self):
        try:
            while True:
                time.sleep(self.interval)
                frame = sys._current_frames().get(self._main)
                chain = []
                while frame is not None:
                    name = frame.f_code.co_filename
                    if any(m in name for m in self.match):
                        chain.append(f"{_short(name)}:"
                                     f"{frame.f_code.co_name}:"
                                     f"{frame.f_lineno}")
                    frame = frame.f_back
                self.samples.append((self.now(), chain[::-1]))
        except Exception as e:      # noqa: BLE001 — say why sampling ended
            print(f"stack_sample: sampling stopped at {self.now()} s: "
                  f"{e!r}", file=sys.stderr)

    def _stop(self, seconds):
        code = 0
        try:
            time.sleep(seconds)
            self.write()
        except Exception as e:      # noqa: BLE001 — exit loudly, never hang
            print(f"stack_sample: writing {self.out} failed: {e!r}",
                  file=sys.stderr)
            code = 1
        os._exit(code)

    def write(self):
        with self._lock:
            if self._written:
                return
            self._written = True
            with open(self.out, "w") as f:
                json.dump({"interval": self.interval, "marks": self.marks,
                           "samples": list(self.samples)}, f)


class _MarkedStdout:
    """stdout that notes when a line starting with `prefix` is written."""

    def __init__(self, stream, prefix, sampler):
        self._stream, self._prefix, self._sampler = stream, prefix, sampler

    def write(self, s):
        if s.startswith(self._prefix) and "mark" not in self._sampler.marks:
            self._sampler.marks["mark"] = self._sampler.now()
        return self._stream.write(s)

    def __getattr__(self, name):
        return getattr(self._stream, name)


def _short(path: str) -> str:
    for cut in ("site-packages/", "dist-packages/"):
        if cut in path:
            return path.split(cut, 1)[1]
    return os.path.relpath(path) if os.path.isabs(path) else path


def report(path, top=40, out=sys.stdout):
    """Seconds by function (inclusive) and by innermost frame."""
    with open(path) as f:
        doc = json.load(f)
    dt = doc["interval"]
    inclusive, innermost = collections.Counter(), collections.Counter()
    for _, chain in doc["samples"]:
        seen = {frame.rsplit(":", 1)[0] for frame in chain}
        for func in seen:
            inclusive[func] += dt
        innermost[chain[-1] if chain else "(outside the matched files)"] \
            += dt
    print(f"{len(doc['samples'])} samples every {dt} s; marks "
          f"{doc['marks']}", file=out)
    print("seconds by function (inclusive):", file=out)
    for func, s in inclusive.most_common(top):
        print(f"{s:9.1f}  {func}", file=out)
    print("seconds by innermost frame:", file=out)
    for frame, s in innermost.most_common(top):
        print(f"{s:9.1f}  {frame}", file=out)


_VALUED = ("--out", "--interval", "--match", "--mark", "--stop-after",
           "--report")


def _split(argv):
    """(this tool's arguments, the module or None, the program's
    arguments): the program starts at `-m MODULE` or at the first word
    that is neither an option of this tool nor an option's value."""
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-m":
            return argv[:i], (argv[i + 1] if i + 1 < len(argv) else None), \
                argv[i + 2:]
        if a in _VALUED:
            i += 2
        elif a.startswith("-"):
            i += 1
        else:
            return argv[:i], None, argv[i:]
    return argv, None, []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="the samples' JSON file")
    ap.add_argument("--interval", type=float, default=0.2)
    ap.add_argument("--match", action="append", default=None,
                    help="keep frames whose file name holds this "
                         "(repeatable)")
    ap.add_argument("--mark", default=None, metavar="PREFIX")
    ap.add_argument("--stop-after", type=float, default=None)
    ap.add_argument("--report", metavar="SAMPLES", default=None)
    own, module, rest = _split(list(sys.argv[1:] if argv is None
                                     else argv))
    args = ap.parse_args(own)
    if args.report:
        report(args.report)
        return 0
    if not args.out or not (module or rest):
        ap.error("--out and a script or -m MODULE are needed")
    if module:
        name, match = module, args.match or [module.split(".")[0]]
    else:
        name, rest = os.path.abspath(rest[0]), rest[1:]
        match = args.match or [name]
    sampler = _Sampler(args.interval, match, args.out, args.stop_after)
    if args.mark:
        sys.stdout = _MarkedStdout(sys.stdout, args.mark, sampler)
    sys.argv = [name] + list(rest)
    code = 0
    try:
        if module:
            runpy.run_module(name, run_name="__main__", alter_sys=True)
        else:
            sys.path.insert(0, os.path.dirname(name))
            runpy.run_path(name, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    finally:
        sampler.write()
    return code


if __name__ == "__main__":
    sys.exit(main())
