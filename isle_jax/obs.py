"""Observability: phase timers, channelized logging, and SpMM FLOP
accounting.

Mirrors the reference's subsystems:
  - Timer (include/timer.h:17-122): per-phase wall+CPU seconds, streamed to
    stdout and appended to `timerLog.txt` in the run directory.
  - Logger (include/logger.h:19-95, src/logger.cpp): channels
    info/trace/warning/error/timer/diagnostic with injectable sinks (the
    C-callback hooks for host embedding become plain Python callables) and
    file sinks `timerLog.txt` / `diagnosticLog.txt`.
  - SpMM self-profiling (include/matUtils.h:270-308): op-call count, total
    seconds, and derived GFLOP/s, printed when the phase closes.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List, Optional


class NoAcceleratorError(RuntimeError):
    """A device measurement found no GPU; it never falls back to the CPU."""


def device_record() -> dict:
    """{"platform", "kind", "count"} of the JAX devices, which must be GPUs
    (NoAcceleratorError otherwise)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoAcceleratorError(
            f"no GPU: JAX found {len(devs)} {devs[0].platform} device(s)"
        )
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


def card_line() -> str:
    """The cards' name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them ("; "-joined over
    cards). A child process: it does not touch JAX. A card may run below
    its maximum power limit, so every time reported carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX_COMPILATION_CACHE_DIR, when set, is the directory, and nothing
    else is configured. Otherwise the cache lives in `<checkout>/.jax_cache`
    (listed in .gitignore): a fixed path, because the path is part of the
    cache key and every entry point of one checkout should hit it."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path


_COMPILE_LOG: List[tuple] = []


def enable_compile_log() -> List[tuple]:
    """Attribute cold-run time to individual XLA compiles: records
    (fun_name, seconds) for every backend compile. Call once before
    tracing; read/clear the returned list (also via compile_log_top).
    Idempotent."""
    if getattr(enable_compile_log, "_on", False):
        return _COMPILE_LOG
    from jax import monitoring

    def _lis(event: str, dur: float, **kw) -> None:
        if event.endswith("backend_compile_duration"):
            _COMPILE_LOG.append((kw.get("fun_name", "?"), dur))

    monitoring.register_event_duration_secs_listener(_lis)
    enable_compile_log._on = True
    return _COMPILE_LOG


def compile_log_top(n: int = 8) -> List[tuple]:
    """Top-n slowest compiles so far as (fun_name, seconds), slowest
    first — the 'program-size evidence' for cold-tail attribution."""
    return sorted(_COMPILE_LOG, key=lambda t: -t[1])[:n]


class Logger:
    CHANNELS = ("info", "trace", "warning", "error", "timer", "diagnostic")

    def __init__(self, run_dir: Optional[str] = None, quiet: bool = False):
        self.run_dir = run_dir
        self.quiet = quiet
        self.sinks: Dict[str, List[Callable[[str], None]]] = {
            c: [] for c in self.CHANNELS
        }
        self._files = {}
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._files["timer"] = open(os.path.join(run_dir, "timerLog.txt"), "a")
            self._files["diagnostic"] = open(
                os.path.join(run_dir, "diagnosticLog.txt"), "a"
            )

    def add_sink(self, channel: str, fn: Callable[[str], None]) -> None:
        self.sinks[channel].append(fn)

    def log(self, channel: str, msg: str) -> None:
        line = msg if msg.endswith("\n") else msg + "\n"
        if not self.quiet and channel in ("info", "warning", "error", "timer"):
            print(line, end="", flush=True)
        f = self._files.get(channel)
        if f:
            f.write(line)
            f.flush()
        for fn in self.sinks[channel]:
            fn(msg)

    def info(self, msg: str) -> None:
        self.log("info", msg)

    def warning(self, msg: str) -> None:
        self.log("warning", "WARNING: " + msg)

    def error(self, msg: str) -> None:
        self.log("error", "ERROR: " + msg)

    def diag(self, msg: str) -> None:
        self.log("diagnostic", msg)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class Timer:
    """Phase timer: `next("label")` reports the wall+CPU time since the
    previous mark and restarts the clock."""

    def __init__(self, logger: Optional[Logger] = None, name: str = ""):
        self.logger = logger
        self.name = name
        self.t0_wall = time.perf_counter()
        self.t0_cpu = time.process_time()
        self.start_wall = self.t0_wall
        self.phases: List[tuple] = []

    def next(self, label: str) -> float:
        wall = time.perf_counter() - self.t0_wall
        cpu = time.process_time() - self.t0_cpu
        self.phases.append((label, wall, cpu))
        msg = f"Time for {label}: {cpu:.3f}s user, {wall:.3f}s wall"
        if self.logger:
            self.logger.log("timer", msg)
        self.t0_wall = time.perf_counter()
        self.t0_cpu = time.process_time()
        return wall

    def diag(self, msg: str) -> None:
        if self.logger:
            self.logger.diag(msg)

    def total(self) -> float:
        return time.perf_counter() - self.start_wall

    def report_total(self, label: str = "total") -> float:
        t = self.total()
        if self.logger:
            self.logger.log("timer", f"Total time for {label}: {t:.3f}s wall")
        return t


class OpCounter:
    """SpMM operator profiling: call count, seconds, FLOPs -> GFLOP/s."""

    def __init__(self, name: str = "spmm"):
        self.name = name
        self.calls = 0
        self.seconds = 0.0
        self.flops = 0

    def add(self, seconds: float, flops: int, calls: int = 1) -> None:
        self.calls += calls
        self.seconds += seconds
        self.flops += flops

    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.name}: {self.calls} calls, {self.seconds:.3f}s, "
            f"{self.flops / 1e9:.2f} GFLOP, {self.gflops():.1f} GFLOP/s"
        )
