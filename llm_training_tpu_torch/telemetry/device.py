"""Device gauges: the card's memory occupancy (`hbm/*`) and its timeline.

Counterpart of `hbm_gauges` and `HBMTimeline` in
`llm_training_tpu/telemetry/device.py`, over PyTorch's caching allocator
instead of PJRT's, under JAX's `hbm/*` key names:

- `hbm/bytes_in_use`: `torch.cuda.memory_allocated` (the tensors alive);
- `hbm/peak_bytes_in_use`: `torch.cuda.max_memory_allocated` (since the
  last `reset_peak_memory_stats`);
- `hbm/bytes_limit`: the card's total memory (`torch.cuda.mem_get_info`);
- `hbm/bytes_reserved`: what the allocator holds from the driver (PJRT has
  no counterpart: JAX's allocator reserves up front);
- `hbm/devices`, and with more than one card in use the worst card (the
  one nearest its limit), the mean and per-card gauges, as JAX's.

PJRT's `largest_alloc_size` has no counterpart in the caching allocator's
statistics and is not emitted. A device that is not CUDA (the CPU tests)
falls back to the process's resident set size, as JAX's gauges do on a
backend without allocator statistics (`hbm/host_fallback` 1).

JAX's `compiled_cost_gauges` and `compiled_attribution_gauges` read an
XLA executable's cost analysis and its HLO; eager PyTorch has neither, so
the port emits no `xla/*` gauges (ROADMAP C).
"""

from __future__ import annotations

import json
import logging
import os
import resource
import sys
import time
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

_MEMORY_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit", "bytes_reserved")


def _host_rss_bytes() -> tuple[float | None, float | None]:
    """(current, peak) resident set size of this process, or Nones."""
    current = peak = None
    try:
        # ru_maxrss is KiB on Linux but bytes on macOS
        scale = 1.0 if sys.platform == "darwin" else 1024.0
        peak = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * scale
    except Exception:  # pragma: no cover - non-POSIX
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        current = float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:  # pragma: no cover - non-Linux
        pass
    return current, peak


def local_device_memory_stats(device: torch.device | str | None = None) -> list[tuple[int, dict]]:
    """[(card index, stats)] for the CUDA cards this process allocated on
    (and `device`'s card); [] when `device` is not CUDA, or with no device
    given when CUDA has not been initialized. Reading a card's total memory
    needs a context on it, so cards the process never used are left out."""
    if device is not None and torch.device(device).type != "cuda":
        return []
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    wanted = {torch.device(device).index or 0} if device is not None else set()
    out: list[tuple[int, dict]] = []
    for index in range(torch.cuda.device_count()):
        if index not in wanted and torch.cuda.memory_reserved(index) == 0:
            continue
        try:
            _, total = torch.cuda.mem_get_info(index)
            stats = {
                "bytes_in_use": float(torch.cuda.memory_allocated(index)),
                "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(index)),
                "bytes_limit": float(total),
                "bytes_reserved": float(torch.cuda.memory_reserved(index)),
            }
        except Exception:  # noqa: BLE001 -- a per-card probe must not raise
            continue
        out.append((index, stats))
    return out


def _device_pressure(stats: dict) -> float:
    """How close a card is to its own limit: in-use over limit."""
    used = float(stats.get("bytes_in_use", 0.0) or 0.0)
    limit = float(stats.get("bytes_limit", 0.0) or 0.0)
    return used / limit if limit > 0 else used


def _gauges_from_stats(per_device: list[tuple[int, dict]]) -> dict[str, float]:
    """`hbm/*` gauges of a per-card sample: the worst card under the flat
    keys (every `hbm/<key>` from the same card), plus rollups and per-card
    gauges with more than one card; the process's RSS without any."""
    out: dict[str, float] = {}
    if per_device:
        worst_id, worst = max(per_device, key=lambda kv: _device_pressure(kv[1]))
        for key in _MEMORY_STAT_KEYS:
            if key in worst:
                out[f"hbm/{key}"] = float(worst[key])
        out["hbm/devices"] = float(len(per_device))
        if len(per_device) > 1:
            in_use = [float(s.get("bytes_in_use", 0.0) or 0.0) for _, s in per_device]
            out["hbm/worst_device"] = float(worst_id)
            out["hbm/mean_bytes_in_use"] = sum(in_use) / len(in_use)
            for device_id, stats in per_device:
                for key in ("bytes_in_use", "peak_bytes_in_use"):
                    if key in stats:
                        out[f"hbm/device{device_id}/{key}"] = float(stats[key])
        return out
    current, peak = _host_rss_bytes()
    if current is not None:
        out["hbm/bytes_in_use"] = current
    if peak is not None:
        out["hbm/peak_bytes_in_use"] = peak
    if out:
        out["hbm/host_fallback"] = 1.0
    return out


def hbm_gauges(device: torch.device | str | None = None) -> dict[str, float]:
    """`hbm/*` gauges of the cards in use (`device`'s included), worst card
    first-class; the process's RSS when `device` is not CUDA."""
    return _gauges_from_stats(local_device_memory_stats(device))


class HBMTimeline:
    """Bounded per-card memory timeline in the run directory, as JAX's
    (the trainer gives it a logger's run directory only: unlike JAX's, it
    never writes into the checkpoint directory, which holds steps only).

    Sampled from the owning loop on log steps (one thread, no locking):
    each sample returns the `hbm/*` gauges for the metrics, appends one
    record to `<run_dir>/hbm.jsonl` (at most `LLMT_HBM_TIMELINE_MAX`
    records), and counts `hbm_timeline/highwater_events` (with a warning)
    the first time a card crosses `LLMT_HBM_HIGHWATER_FRAC` of its memory,
    re-armed when it falls back below. JAX also emits a trace instant
    there; the tracer is not ported yet (ROADMAP A.7)."""

    def __init__(
        self,
        run_dir=None,
        registry=None,
        device: torch.device | str | None = None,
        max_records: int | None = None,
        highwater_frac: float | None = None,
        clock=time.time,
    ):
        self.path = Path(run_dir) / "hbm.jsonl" if run_dir else None
        self._registry = registry
        self._device = device
        self._clock = clock
        if max_records is None:
            max_records = int(os.environ.get("LLMT_HBM_TIMELINE_MAX") or 2048)
        self.max_records = max(1, max_records)
        if highwater_frac is None:
            highwater_frac = float(os.environ.get("LLMT_HBM_HIGHWATER_FRAC") or 0.9)
        self.highwater_frac = highwater_frac
        self._records = 0
        self._truncated = False
        self._over: set[int] = set()  # cards currently above high water
        self._highwater_events = 0

    def sample(self, step: int) -> dict[str, float]:
        """One timeline sample; returns the `hbm/*` gauges for the log
        step's metrics (plus `hbm_timeline/*` meta-gauges)."""
        per_device = local_device_memory_stats(self._device)
        gauges = _gauges_from_stats(per_device)
        self._check_highwater(step, per_device)
        self._append(step, per_device, gauges)
        gauges["hbm_timeline/records"] = float(self._records)
        if self._truncated:
            gauges["hbm_timeline/truncated"] = 1.0
        if self._highwater_events:
            gauges["hbm_timeline/highwater_events"] = float(self._highwater_events)
        return gauges

    def _check_highwater(self, step, per_device) -> None:
        for device_id, stats in per_device:
            limit = float(stats.get("bytes_limit", 0.0) or 0.0)
            if limit <= 0:
                continue
            frac = float(stats.get("bytes_in_use", 0.0) or 0.0) / limit
            if frac >= self.highwater_frac and device_id not in self._over:
                self._over.add(device_id)
                self._highwater_events += 1
                if self._registry is not None:
                    self._registry.counter("hbm_timeline/highwater_events").inc()
                logger.warning("device %d memory high water: %.1f%% of %.2f GiB at step %d",
                               device_id, frac * 100, limit / 2**30, step)
            elif frac < self.highwater_frac:
                self._over.discard(device_id)

    def _append(self, step, per_device, gauges) -> None:
        if self.path is None:
            return
        if self._records >= self.max_records:
            if not self._truncated:
                self._truncated = True
                logger.warning("hbm timeline capped at %d records (%s); later samples keep "
                               "the gauges but stop appending", self.max_records, self.path)
            return
        record: dict = {"step": int(step), "t": self._clock()}
        if per_device:
            record["devices"] = [
                {"id": device_id, **{k: stats[k] for k in _MEMORY_STAT_KEYS if k in stats}}
                for device_id, stats in per_device
            ]
        else:
            # the RSS fallback (CPU): still a timeline of process memory
            record["host_fallback"] = True
            for key in ("hbm/bytes_in_use", "hbm/peak_bytes_in_use"):
                if key in gauges:
                    record[key.split("/", 1)[1]] = gauges[key]
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
            self._records += 1
        except OSError as e:
            logger.warning("hbm timeline append failed: %s", e)
