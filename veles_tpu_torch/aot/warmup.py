"""Startup wiring: the process's plan, warm ladders, the startup report.

Port of ``veles_tpu/aot/warmup.py``. One process-wide :class:`Plan`
(armed by ``--aot-cache DIR`` / ``--aot-export PKG``, or
:func:`configure`) is consulted by every capture site of the engines
and trainers (:meth:`Plan.captured`, the counterpart of
``Plan.jitted``). A site always captures in its own process, then
hands the plan the capture's record (``aot/export.py``):

* **hit** — a record of the entry exists (package bundle first, then
  the artifact cache) and the fresh capture's input specs, donation,
  kernels and launch tally equal it;
* **mismatch** — the record differs: logged, counted as a fallback,
  the fresh capture stands and its record replaces the old one;
* **miss** — no record: the fresh one is written (the next process
  plans the entry).

:func:`warm_engine` captures every planned entry of an engine before
its port opens, then its derivable bucket ladder up to
``warm_max_batch``; so a replica started on a warm ``DIR`` builds no
kernel (``DIR/kernels/``) and serves the buckets earlier traffic used
without a capture after ready. The window from :func:`configure` to
:func:`startup_report` runs under a
:class:`~veles_tpu_torch.analysis.recompile.CaptureWatcher`, and a
second one counts the captures after ready: a warm replica reports
``0 fresh`` kernel builds.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from veles_tpu_torch.analysis.recompile import CaptureWatcher
from veles_tpu_torch.aot import export as aot_export
from veles_tpu_torch.aot import package as aot_package
from veles_tpu_torch.aot.cache import ArtifactCache, configure_kernel_cache
from veles_tpu_torch.aot.export import AotUnavailable

log = logging.getLogger("veles_aot")

_lock = threading.Lock()
# guarded-by: _lock
_plan: Optional["Plan"] = None

#: an InferenceEngine bucket's entry name
_FORWARD = re.compile(r"^forward/(\d+(?:x\d+)*)$")


class Plan:
    """The process's AOT posture: the artifact cache, the kernel
    directory, the export target and the startup accounting.
    Thread-safe: capture sites may race from dispatch threads."""

    def __init__(self, cache_dir: Optional[str] = None,
                 export_to: Optional[str] = None,
                 max_bytes: Optional[int] = None) -> None:
        self.cache_dir = cache_dir
        self.export_to = export_to
        self.cache: Optional[ArtifactCache] = None
        self.kernel_dir: Optional[str] = None
        if cache_dir:
            self.kernel_dir = os.path.join(cache_dir, "kernels")
            configure_kernel_cache(self.kernel_dir)
            kwargs = {} if max_bytes is None else {"max_bytes": max_bytes}
            self.cache = ArtifactCache(os.path.join(cache_dir, "artifacts"),
                                       **kwargs)
        self._lock = threading.Lock()
        # guarded-by: _lock; (fingerprint, name) -> packed record
        self._export_entries: Dict[Tuple[str, str], bytes] = {}
        # counters (guarded-by: _lock)
        self.hits = 0
        self.misses = 0
        self.mismatches = 0
        self.fallbacks = 0
        self.exports = 0
        self._watcher = CaptureWatcher(label="aot startup")
        self._watcher.__enter__()
        self._after: Optional[CaptureWatcher] = None
        self._t0 = time.monotonic()
        from veles_tpu_torch.ops import _build
        self._build_s0 = _build.BUILDS["fresh_s"]
        self.report: Optional[Dict[str, Any]] = None

    # -- the capture-site surface -------------------------------------------
    def lookup(self, fingerprint: str, name: str,
               bundle: Optional["Bundle"] = None
               ) -> Optional[Dict[str, Any]]:
        """The planned record of ``fingerprint/name`` (bundle first,
        then the cache), or None; an unreadable record is a fallback."""
        blob = bundle.get(fingerprint, name) if bundle is not None \
            else None
        if blob is None and self.cache is not None:
            blob = self.cache.get(fingerprint, name)
        if blob is None:
            return None
        try:
            return aot_export.unpack_record(blob)
        except AotUnavailable as e:
            with self._lock:
                self.fallbacks += 1
            log.warning("aot: entry %s unusable (%s): capturing afresh",
                        name, e)
            return None

    def captured(self, fingerprint: str, name: str, record: Dict[str, Any],
                 bundle: Optional["Bundle"] = None,
                 owner: str = "engine") -> str:
        """A capture site made ``record``'s capture: returns "hit",
        "mismatch" or "miss" (see the module docstring); a mismatch or
        a miss writes the fresh record."""
        planned = self.lookup(fingerprint, name, bundle)
        if planned is not None:
            diffs = aot_export.record_differences(planned, record)
            if not diffs:
                with self._lock:
                    self.hits += 1
                log.debug("aot: %s planned and captured (%s)", name, owner)
                self._note_export(fingerprint, name, record)
                return "hit"
            with self._lock:
                self.mismatches += 1
                self.fallbacks += 1
            log.warning("aot: %s (%s) captured unlike its record (%s): "
                        "the fresh capture stands", name, owner,
                        ", ".join(diffs))
            outcome = "mismatch"
        else:
            with self._lock:
                self.misses += 1
            outcome = "miss"
        packed = aot_export.pack_record(record)
        if self.cache is not None:
            self.cache.put(fingerprint, name, packed)
        with self._lock:
            self.exports += 1
        self._note_export(fingerprint, name, record, packed)
        return outcome

    def _note_export(self, fingerprint: str, name: str,
                     record: Dict[str, Any],
                     packed: Optional[bytes] = None) -> None:
        if self.export_to:
            with self._lock:
                self._export_entries[(fingerprint, name)] = \
                    packed or aot_export.pack_record(record)

    def planned(self, fingerprint: str,
                bundle: Optional["Bundle"] = None) -> List[str]:
        """Entry names recorded for ``fingerprint`` (bundle and cache)."""
        names = set(bundle.entries_for(fingerprint)) \
            if bundle is not None else set()
        if self.cache is not None:
            names.update(self.cache.entries(fingerprint))
        return sorted(names)

    # -- startup accounting --------------------------------------------------
    def finish_startup(self) -> Tuple[Dict[str, Any], bool]:
        """Close the startup window (idempotent) and start counting the
        captures after ready; returns ``(report, closed-just-now)``."""
        from veles_tpu_torch.ops import _build
        with self._lock:
            first = self.report is None
            if first:
                seconds = time.monotonic() - self._t0
                self._watcher.__exit__(None, None, None)
                w = self._watcher
                self.report = {
                    "seconds": seconds,
                    "fresh_builds": w.fresh_build_count,
                    "cached_builds": w.cached_build_count,
                    "fresh_build_s": _build.BUILDS["fresh_s"] -
                    self._build_s0,
                    "captures_before_ready": w.capture_count,
                    "graphs_before_ready": w.graph_count,
                }
                self._after = CaptureWatcher(label="aot after ready")
                self._after.__enter__()
            report = dict(self.report, aot_hits=self.hits,
                          aot_misses=self.misses,
                          aot_fallbacks=self.fallbacks,
                          captures_after_ready=self.captures_after_ready)
        return report, first

    @property
    def captures_after_ready(self) -> Optional[int]:
        after = self._after
        if after is not None:
            return after.capture_count
        return None if self.report is None else \
            self.report.get("captures_after_ready")

    def close(self) -> None:
        """Stop both watchers (a superseded or dropped plan)."""
        self.finish_startup()
        with self._lock:
            after, self._after = self._after, None
        if after is not None:
            self.report["captures_after_ready"] = after.capture_count
            after.__exit__(None, None, None)

    # -- export flush --------------------------------------------------------
    def flush_export(self) -> Optional[str]:
        """Write the records of this process into ``export_to``: as
        ``aot/`` members of an existing package archive, else a
        standalone bundle archive. Entries are keyed
        ``<fingerprint>/<name>`` and each records its fingerprint, so
        one bundle carries several families (an engine and a
        trainer). Returns the written path or None."""
        with self._lock:
            entries = dict(self._export_entries)
            target = self.export_to
        if not target or not entries:
            return None
        manifest_entries = {}
        files = {}
        for (fp, name), blob in entries.items():
            member = _member_name(fp, name)
            manifest_entries["%s/%s" % (fp, name)] = {
                "file": member, "fingerprint": fp, "name": name}
            files[aot_package.AOT_PREFIX + member] = blob
        manifest = {"format": aot_export.FORMAT_VERSION,
                    "env": aot_export.environment_signature(),
                    "fingerprints": sorted({fp for fp, _ in entries}),
                    "entries": manifest_entries}
        files[aot_package.AOT_MANIFEST] = json.dumps(
            manifest, indent=2, sort_keys=True).encode()
        if os.path.exists(target):
            aot_package.embed_files(target, files)
        else:
            aot_package.write_bundle_archive(target, files)
        log.info("aot: exported %d entr%s to %s", len(entries),
                 "y" if len(entries) == 1 else "ies", target)
        return target

    def status_doc(self) -> Dict[str, Any]:
        """The plan's counters and startup report (``/metrics``)."""
        with self._lock:
            doc: Dict[str, Any] = {
                "hits": self.hits, "misses": self.misses,
                "mismatches": self.mismatches,
                "fallbacks": self.fallbacks, "exports": self.exports}
            if self.report is not None:
                doc.update({k: v for k, v in self.report.items()
                            if k != "seconds"})
                doc["cold_start_s"] = self.report["seconds"]
                doc["captures_after_ready"] = self.captures_after_ready
        if self.cache is not None:
            doc["cache"] = self.cache.stats()
        if self.kernel_dir is not None:
            doc["kernel_dir"] = self.kernel_dir
        return doc

    def metrics_samples(self):
        """``veles_aot_*`` samples for the obs registry collector."""
        from veles_tpu_torch.obs.metrics import Sample
        doc = self.status_doc()
        out = [Sample("veles_aot_%s_total" % key, "counter",
                      float(doc[key]))
               for key in ("hits", "misses", "mismatches", "fallbacks",
                           "exports")]
        for key in ("cold_start_s", "fresh_builds", "cached_builds",
                    "captures_before_ready", "captures_after_ready"):
            if doc.get(key) is not None:
                name = "veles_aot_cold_start_seconds" \
                    if key == "cold_start_s" else "veles_aot_" + key
                out.append(Sample(name, "gauge", float(doc[key])))
        stats = doc.get("cache")
        if stats is not None:
            out.append(Sample("veles_aot_cache_bytes", "gauge",
                              float(stats["bytes"])))
            out.append(Sample("veles_aot_cache_evictions_total",
                              "counter", float(stats["evictions"])))
            out.append(Sample("veles_aot_cache_corrupt_total", "counter",
                              float(stats["corrupt"])))
        return out


class Bundle:
    """The ``aot/`` members of a package archive, fingerprint-gated per
    entry: :meth:`get` serves only an exact ``(fingerprint, name)``
    match, and an entry of the same name under another fingerprint is
    logged once and counted as a fallback of the active plan."""

    def __init__(self, manifest: Dict[str, Any],
                 blob_reader: Callable[[str], bytes], source: str) -> None:
        self.manifest = manifest
        self._read = blob_reader
        self.source = source
        self._warned = False

    @property
    def fingerprints(self) -> Tuple[str, ...]:
        return tuple(self.manifest.get("fingerprints") or ())

    def entry_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.manifest.get("entries") or ()))

    def entries_for(self, fingerprint: str) -> List[str]:
        entries = self.manifest.get("entries") or {}
        return sorted(e["name"] for e in entries.values()
                      if isinstance(e, dict) and
                      e.get("fingerprint") == fingerprint and "name" in e)

    def get(self, fingerprint: str, name: str) -> Optional[bytes]:
        entries = self.manifest.get("entries") or {}
        entry = entries.get("%s/%s" % (fingerprint, name))
        if entry is None:
            mismatch = any(
                isinstance(e, dict) and e.get("name") == name and
                e.get("fingerprint") != fingerprint
                for e in entries.values())
            if mismatch and not self._warned:
                self._warned = True
                log.warning(
                    "aot: package %s was exported for another "
                    "configuration (no entry matches hash %.12s): its "
                    "records are ignored (the weights still load)",
                    self.source, fingerprint)
                plan = active()
                if plan is not None:
                    with plan._lock:
                        plan.fallbacks += 1
            return None
        try:
            return self._read(aot_package.AOT_PREFIX + entry["file"])
        except (OSError, KeyError, ValueError) as e:
            log.warning("aot: package %s entry %s unreadable (%s)",
                        self.source, name, e)
            return None


def read_bundle(path: str) -> Optional[Bundle]:
    """The package archive's AOT bundle, or None (no ``aot/`` members,
    or an unreadable manifest: logged, never raised)."""
    try:
        pkg = aot_package.extract_package(path)
        if aot_package.AOT_MANIFEST not in pkg.members:
            return None
        manifest = json.loads(pkg.aot_blob(aot_package.AOT_MANIFEST))
        if not isinstance(manifest, dict):
            raise ValueError("manifest is not an object")
    except aot_package.UnsafeArchive:
        raise
    except Exception as e:  # noqa: BLE001 — the bundle is optional
        log.warning("aot: cannot read the bundle of %s (%s): capturing "
                    "afresh", path, e)
        return None
    return Bundle(manifest, pkg.aot_blob, os.path.basename(path))


# -- the process-wide plan ---------------------------------------------------

def configure(cache_dir: Optional[str] = None,
              export_to: Optional[str] = None,
              max_bytes: Optional[int] = None) -> Plan:
    """Arm the process's plan (CLI: ``--aot-cache`` / ``--aot-export``),
    replacing any earlier one, and register the ``veles_aot_*``
    collector in the process metrics registry."""
    global _plan
    plan = Plan(cache_dir=cache_dir, export_to=export_to,
                max_bytes=max_bytes)
    with _lock:
        old, _plan = _plan, plan
    if old is not None:
        old.close()
    from veles_tpu_torch.obs import metrics as obs_metrics
    obs_metrics.REGISTRY.register("aot", plan.metrics_samples)
    return plan


def active() -> Optional[Plan]:
    with _lock:
        return _plan


def deactivate() -> None:
    """Drop the process's plan: capture sites go back to capturing
    unplanned, and kernels to ``ops/csrc/build/``."""
    global _plan
    with _lock:
        old, _plan = _plan, None
    if old is not None:
        old.close()
        if old.kernel_dir is not None:
            configure_kernel_cache(None)
    from veles_tpu_torch.obs import metrics as obs_metrics
    obs_metrics.REGISTRY.unregister("aot")


# -- engine warmup -----------------------------------------------------------

def warm_engine(engine) -> int:
    """Capture an engine's planned entries and its standard ladder
    before the first request; returns the captures added. An
    ``InferenceEngine`` takes its planned buckets first, then the
    buckets up to ``warm_max_batch`` of its input hint (none without
    one); a generative engine runs its whole ladder (``warm``)."""
    from veles_tpu_torch.serve.engine import (GenerativeEngine,
                                              InferenceEngine,
                                              PagedGenerativeEngine)
    if isinstance(engine, (GenerativeEngine, PagedGenerativeEngine)):
        return engine.warm()
    if not isinstance(engine, InferenceEngine):
        return 0
    before = engine.compile_count
    plan = active()
    fp = engine._fingerprint()
    shapes = []
    if fp is not None:
        names = set(engine._aot_bundle.entries_for(fp)) \
            if engine._aot_bundle is not None else set()
        if plan is not None:
            names.update(plan.planned(fp))
        for name in sorted(names):
            m = _FORWARD.match(name)
            if m:
                shapes.append(tuple(int(d) for d in m.group(1).split("x")))
    import numpy as np
    for shape in sorted(shapes):
        engine.apply(np.zeros(shape, engine.input_dtype))
    hint = engine.input_hint
    if hint is not None:
        engine.warmup(tuple(hint), engine.warm_max_batch)
    elif not shapes:
        log.info("aot: engine %s has no input-shape hint and nothing "
                 "planned: capturing on first traffic", engine.name)
    return engine.compile_count - before


def startup_report(context: str = "serve") -> Optional[Dict[str, Any]]:
    """Close the startup window on the active plan and log its counts
    (the line the warm-start tests read)."""
    plan = active()
    if plan is None:
        return None
    report, first = plan.finish_startup()
    if first:
        log.info(
            "aot startup (%s): %d fresh kernel build(s) in %.2fs, %d "
            "from the cache, %d capture(s) before ready, %d planned "
            "entr(y/ies) hit, %d missed, %d record(s) written, %.2fs to "
            "ready", context, report["fresh_builds"],
            report["fresh_build_s"], report["cached_builds"],
            report["captures_before_ready"], report["aot_hits"],
            report["aot_misses"], plan.exports, report["seconds"])
    return report


def flush_export() -> Optional[str]:
    plan = active()
    if plan is None:
        return None
    try:
        return plan.flush_export()
    except Exception:  # noqa: BLE001 — an export never fails a run
        log.warning("aot: export flush failed", exc_info=True)
        return None


def status_doc() -> Optional[Dict[str, Any]]:
    plan = active()
    return plan.status_doc() if plan is not None else None


def _member_name(fingerprint: str, name: str) -> str:
    # the fingerprint prefix keeps same-named entries of different
    # families apart in one archive
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in name)
    return "%s_%s.rec" % (fingerprint[:12], safe)


# -- the capture sites' hook -------------------------------------------------

def _bundle_outcome(bundle: Bundle, fingerprint: str, name: str,
                    record: Dict[str, Any]) -> str:
    """A package bundle's verdict on a capture, without a plan."""
    blob = bundle.get(fingerprint, name)
    if blob is None:
        return "miss"
    try:
        planned = aot_export.unpack_record(blob)
    except AotUnavailable as e:
        log.warning("aot: package entry %s unusable (%s)", name, e)
        return "fallback"
    diffs = aot_export.record_differences(planned, record)
    if diffs:
        log.warning("aot: %s captured unlike the package's record (%s): "
                    "the fresh capture stands", name, ", ".join(diffs))
        return "mismatch"
    return "hit"


def note(site, fingerprint: Callable[[], Optional[str]], name: str,
         inputs, donation=(), launches: Optional[Dict[str, int]] = None,
         captured: bool = True, bundle: Optional[Bundle] = None,
         owner: str = "engine") -> Optional[str]:
    """A capture site (an engine or a trainer, ``site``) made the
    capture of entry ``name``: hand its record to the active plan, or
    to ``bundle`` alone when no plan is armed. ``fingerprint()`` is
    asked only then. Bumps ``site.aot_hits``, ``aot_misses`` or
    ``aot_fallbacks``; returns the outcome, or None when nothing plans
    the site."""
    plan = active()
    if plan is None and bundle is None:
        return None
    fp = fingerprint()
    if fp is None:
        return None
    record = aot_export.make_record(name, fp, aot_export.specs_of(inputs),
                                    donation, launches, captured)
    if plan is not None:
        outcome = plan.captured(fp, name, record, bundle=bundle,
                                owner=owner)
    else:
        outcome = _bundle_outcome(bundle, fp, name, record)
    attr = {"hit": "aot_hits", "miss": "aot_misses"}.get(outcome,
                                                          "aot_fallbacks")
    setattr(site, attr, getattr(site, attr, 0) + 1)
    return outcome
