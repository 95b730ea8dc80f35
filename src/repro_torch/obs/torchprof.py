"""PyTorch-side observability: scopes, profiler capture, recompile detection.

Counterpart of ``repro/obs/jaxprof.py``; all of it is safe to leave wired
in production code:

  * :func:`annotation` / :func:`named_scope` -- a
    ``torch.profiler.record_function`` region (the profiler's CPU track and
    the kernels launched under it carry its name), inside an NVTX range
    when this process works on the card; the tracer's null span when no
    tracer is configured, so hot loops pay one global read when disabled.
    A running ``torch.profiler`` capture alone never enters one: the
    ``gpu_user_annotation`` range it would leave on the device track reads
    as device work to a consumer of the capture.  Eager PyTorch has no compiled graph whose regions need naming apart
    from the host's, so the two are one function;
  * :func:`profiler_trace` -- the opt-in ``torch.profiler.profile`` capture
    (CPU and, with a card, CUDA activities) written as a Chrome trace into
    ``log_dir``; a profiler that fails to start or stop degrades to a no-op
    with an instant event instead of killing the run;
  * :class:`RecompileWatcher` -- flags *unexpected* growth of what a hot
    function builds at first use.  Eager PyTorch has no jit cache; the
    port's counterparts are the kernel libraries compiled with ``nvcc`` or
    loaded into the process (``kernels.zfp_codec.build`` and
    ``kernels.flash_attention.build`` expose ``_cache_size()``), which
    would stall a steady-state step if they were built again.
    ``watch()`` registers a build function, ``rebase()`` accepts the
    current size as expected (call it after the first step), ``check()``
    returns every build function that grew since -- and mirrors each event
    into the metrics registry and the tracer (``recompile`` instant).

Names are the JAX package's, so one trace or snapshot consumer
(``tools/trace_report.py``) reads either package's runs: the counter is
``jax.recompiles`` and the profiler's failure instants are
``jaxprof.unavailable`` / ``jaxprof.stop_failed``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional

import torch

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry, get_registry


class _Region:
    """A ``record_function`` range, inside an NVTX range on the card."""
    __slots__ = ("_name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


def annotation(name: str):
    """Profiler region marker; null when telemetry is off."""
    if not _trace.enabled():
        return _trace.NULL_SPAN
    return _Region(name)


named_scope = annotation


def block_until_ready(t: torch.Tensor) -> torch.Tensor:
    """Wait for the work queued on the current stream of ``t``'s device (a
    no-op on the CPU), as ``jax.block_until_ready`` waits for an array."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Opt-in ``torch.profiler`` capture (no-op when ``log_dir`` is None);
    writes ``<log_dir>/torch_profile.<pid>.trace.json``."""
    if log_dir is None:
        yield False
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except Exception as e:                   # no CUPTI / backend quirk
        _trace.instant("jaxprof.unavailable", cat="torch", error=repr(e))
        yield False
        return
    try:
        yield True
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"torch_profile.{os.getpid()}.trace.json"))
        except Exception as e:
            _trace.instant("jaxprof.stop_failed", cat="torch", error=repr(e))


def cache_size(fn) -> Optional[int]:
    """What a build function has built into this process (``fn._cache_size()``);
    None when ``fn`` exposes no such count, e.g. a plain Python callable."""
    probe = getattr(fn, "_cache_size", None)
    if probe is None:
        return None
    try:
        return int(probe())
    except Exception:
        return None


@dataclasses.dataclass
class RecompileEvent:
    name: str
    before: int
    after: int

    @property
    def growth(self) -> int:
        return self.after - self.before


class RecompileWatcher:
    """Flags build-cache growth on registered build functions.

    Typical wiring (the train loop and serving engines do exactly this):

        watcher.watch("train.fused_step", zfp_codec.build)
        ... first step (expected build) ...
        watcher.rebase()
        ... steady state ...
        events = watcher.check()     # non-empty => unexpected rebuilds
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._fns: Dict[str, object] = {}
        self._baseline: Dict[str, int] = {}
        self._registry = registry

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def watch(self, name: str, fn) -> None:
        """Register ``fn`` under ``name``; its current size is the baseline."""
        size = cache_size(fn)
        if size is None:
            raise TypeError(f"{name}: has no build cache (no _cache_size); "
                            "watch a kernel module's build function")
        self._fns[name] = fn
        self._baseline[name] = size

    def sizes(self) -> Dict[str, int]:
        return {name: cache_size(fn) for name, fn in self._fns.items()}

    def rebase(self) -> None:
        """Accept the current sizes as expected (after the first step)."""
        self._baseline = self.sizes()

    def check(self) -> List[RecompileEvent]:
        """Every watched build function that grew since the last baseline.

        Each event increments the ``jax.recompiles`` counter and emits a
        ``recompile`` tracer instant, then the baseline absorbs the growth
        (one flag per rebuild, not one per check).
        """
        events = []
        for name, after in self.sizes().items():
            before = self._baseline.get(name, 0)
            if after > before:
                events.append(RecompileEvent(name, before, after))
                self._reg().counter("jax.recompiles").add(after - before)
                _trace.instant("recompile", cat="torch", fn=name,
                               before=before, after=after)
                self._baseline[name] = after
        return events


# Shared process-wide watcher: layers register their build functions here so one
# ``check()`` (end of a train run / serve loop) covers every hot path
# without plumbing a watcher through.
_WATCHER = RecompileWatcher()


def get_watcher() -> RecompileWatcher:
    return _WATCHER
