"""Where an optimizer keeps its per-parameter state, and the loop that
brings that state to the update.

The JAX trainer places every non-scalar `opt_state` leaf in `pinned_host`
memory when `offload_optimizer_state` is on (`_state_shardings`), stores
it through a codec (`offload_state_dtype`: float32, bfloat16, or the int8
block codec of `quantized_state.py`), and brackets the update with copies
to and from the device. `StateStore` is that placement for the port:

- without offload the state is float32 on the parameters' device and the
  loop hands out the live tensors (row slices of them), updated in place;
- with offload on a CUDA device every state tensor lives in pinned host
  memory, stored encoded. The loop stages unit i+1's state into device
  buffers on a copy stream while unit i updates on the compute stream,
  decodes, hands it out, encodes what the caller left there and copies it
  back on a second copy stream. At most two units are staged at once. A
  host tensor that cannot be pinned raises: there is no fallback to
  pageable memory;
- with offload on the CPU (the tests) the "host" is the same memory, as
  JAX's `offload_memory_kinds` degrades on its CPU backend, and the codec
  still applies, so the CPU tests hold its numerics.

A unit is a list of state keys (`<field>.<slot>`) and an optional row
range along dim 0 (a chunk of a large parameter: the elementwise
optimizers' temporaries stay bounded on the device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import torch

from llm_training_tpu_torch.optim.quantized_state import (
    codec_kind,
    dequantize_array,
    eligible,
    quantize_array,
    QuantArray,
)

STATE_DTYPES = ("float32", "bfloat16", "int8")

Unit = tuple[list[str], tuple[int, int] | None]


@dataclass
class _Entry:
    """One state tensor as stored: `parts` is `{"": tensor}` (float32 or
    bfloat16) or `{"q": codes, "scale": scales}` (int8, blocked along
    `axis`)."""

    mode: str
    kind: str | None
    axis: int
    dtype: torch.dtype  # of the exact ("float32") storage: the state's own
    parts: dict[str, torch.Tensor]

    def rows(self, rows: tuple[int, int] | None, block: int) -> dict[str, torch.Tensor]:
        if rows is None:
            return self.parts
        r0, r1 = rows
        out = {}
        for suffix, t in self.parts.items():
            if suffix == "scale" and self.axis == 0:
                out[suffix] = t[r0 // block:r1 // block]
            else:
                out[suffix] = t[r0:r1]
        return out


def check_offload_keys(offload: bool, dtype: str, block: int) -> None:
    """The JAX trainer's errors for `offload_optimizer_state`,
    `offload_state_dtype` and `offload_quant_block` (its `_build_tx`)."""
    if dtype not in STATE_DTYPES:
        raise ValueError(
            f"offload_state_dtype {dtype!r}; expected float32, bfloat16 or int8"
        )
    if dtype != "float32" and not offload:
        raise ValueError(
            "offload_state_dtype != float32 is a storage codec for the "
            "OFFLOADED state; set offload_optimizer_state=True"
        )
    if block < 1:
        raise ValueError(f"offload_quant_block must be >= 1, got {block}")


class StateStore:
    def __init__(self, device: torch.device | str, offload: bool = False,
                 dtype: str = "float32", block: int = 256):
        check_offload_keys(offload, dtype, block)
        self.device = torch.device(device)
        self.offload = offload
        self.dtype = dtype
        self.block = block
        self.entries: dict[str, _Entry] = {}
        self.cuda = offload and self.device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)
        self._written: torch.cuda.Event | None = None
        # with `timing` set, each loop records CUDA events around its copies
        # and updates and leaves their sums in `split` (milliseconds, bytes)
        self.timing = False
        self.split: dict | None = None

    # ------------------------------------------------------------ layout

    def add(self, key: str, value: torch.Tensor, axis: int = -1) -> None:
        """Register `key`'s initial value (on the parameters' device):
        encoded, and moved to pinned host memory under offload."""
        field = key.split(".", 1)[0]
        axis = axis % value.ndim if value.ndim else 0
        mode = "float32"
        if self.offload and codec_kind(field) is not None and value.ndim >= 1:
            if self.dtype == "bfloat16":
                mode = "bfloat16"
            elif self.dtype == "int8" and eligible(field, value, self.block, axis):
                mode = "int8"
        entry = _Entry(mode, codec_kind(field), axis, value.dtype, {})
        parts = self._encode(entry, value)
        if self.offload:
            parts = {suffix: self._host(t) for suffix, t in parts.items()}
        entry.parts = parts
        self.entries[key] = entry

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if not host.is_pinned():
            raise RuntimeError(f"could not pin {host.nbytes} bytes of host memory for "
                               "the offloaded optimizer state")
        host.copy_(t)
        return host

    def host_bytes(self) -> int:
        """Bytes of state held in host memory (0 without offload)."""
        if not self.offload:
            return 0
        return sum(t.nbytes for e in self.entries.values() for t in e.parts.values())

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The stored tensors by key (`<key>.q` and `<key>.scale` for int8
        entries): the live storage, not copies; pending copies to the host
        have landed."""
        self.synchronize()
        out = {}
        for key, entry in self.entries.items():
            for suffix, t in entry.parts.items():
                out[f"{key}.{suffix}" if suffix else key] = t
        return out

    def synchronize(self) -> None:
        if self._written is not None:
            self._written.synchronize()

    # ------------------------------------------------------------ codec

    def _decode(self, entry: _Entry, parts: dict[str, torch.Tensor]) -> torch.Tensor:
        if entry.mode == "int8":
            return dequantize_array(QuantArray(parts["q"], parts["scale"], entry.kind,
                                               self.block, entry.axis))
        return parts[""].float() if entry.mode == "bfloat16" else parts[""]

    def _encode(self, entry: _Entry, value: torch.Tensor) -> dict[str, torch.Tensor]:
        if entry.mode == "int8":
            qa = quantize_array(value, entry.kind, self.block, entry.axis)
            return {"q": qa.q, "scale": qa.scale}
        return {"": value.to(torch.bfloat16 if entry.mode == "bfloat16" else entry.dtype)}

    # ------------------------------------------------------------ the loop

    def stream(self, units: list[Unit], fetch: bool = True,
               write: bool = True) -> Iterator[dict[str, torch.Tensor]]:
        """For each unit, `{key: tensor on the device}` (float32 unless the
        state's own dtype is another) to update in place; the next request writes it back (unless `write` is False).
        With `fetch` False the tensors' contents are undefined (the caller
        overwrites them)."""
        if self.cuda:
            yield from self._stream_cuda(units, fetch, write)
            return
        for keys, rows in units:
            views = {k: self.entries[k].rows(rows, self.block) for k in keys}
            work = {k: self._decode(self.entries[k], views[k]) for k in keys}
            yield work
            if not write:
                continue
            for k in keys:
                entry = self.entries[k]
                if entry.mode == "float32" and work[k] is views[k][""]:
                    continue  # updated in place
                for suffix, t in self._encode(entry, work[k]).items():
                    views[k][suffix].copy_(t)

    def _stream_cuda(self, units, fetch, write):
        compute = torch.cuda.current_stream(self.device)
        timing = {"in": [], "update": [], "out": []} if self.timing else None
        nbytes = {"in": 0, "out": 0}

        def event(stream):
            ev = torch.cuda.Event(enable_timing=timing is not None)
            ev.record(stream)
            return ev

        if self._written is not None:  # the previous loop's copies out land first
            self.h2d.wait_event(self._written)
        done: list[torch.cuda.Event] = []
        staged: dict[int, tuple] = {}

        def stage(i: int) -> None:
            keys, rows = units[i]
            with torch.cuda.stream(self.h2d):
                if i >= 2:  # two units in flight at most: unit i-2's buffers are done
                    self.h2d.wait_event(done[i - 2])
                start = event(self.h2d) if timing is not None else None
                dev = {}
                for k in keys:
                    entry = self.entries[k]
                    host = entry.rows(rows, self.block)
                    if fetch:
                        dev[k] = {s: h.to(self.device, non_blocking=True) for s, h in host.items()}
                        nbytes["in"] += sum(h.nbytes for h in host.values())
                    else:
                        shape = host["q"].shape if entry.mode == "int8" else host[""].shape
                        dtype = entry.dtype if entry.mode == "float32" else torch.float32
                        dev[k] = {"": torch.empty(shape, dtype=dtype, device=self.device)}
                ready = event(self.h2d)
                if timing is not None:
                    timing["in"].append((start, ready))
            staged[i] = (dev, ready)

        if units:
            stage(0)
        for i, (keys, rows) in enumerate(units):
            if i + 1 < len(units):
                stage(i + 1)
            dev, ready = staged.pop(i)
            compute.wait_event(ready)
            for parts in dev.values():
                for t in parts.values():
                    t.record_stream(compute)
            start = event(compute) if timing is not None else None
            work = {k: (self._decode(self.entries[k], dev[k]) if fetch else dev[k][""])
                    for k in keys}
            yield work
            encoded = {k: self._encode(self.entries[k], work[k]) for k in keys} if write else {}
            finished = event(compute)
            done.append(finished)
            if timing is not None:
                timing["update"].append((start, finished))
            if not write:
                continue
            with torch.cuda.stream(self.d2h):
                self.d2h.wait_event(finished)
                start = event(self.d2h) if timing is not None else None
                for k in keys:
                    host = self.entries[k].rows(rows, self.block)
                    for suffix, t in encoded[k].items():
                        host[suffix].copy_(t, non_blocking=True)
                        t.record_stream(self.d2h)
                        nbytes["out"] += t.nbytes
                if timing is not None:
                    timing["out"].append((start, event(self.d2h)))
        self._written = event(self.d2h)
        if timing is not None:
            torch.cuda.synchronize(self.device)
            self.split = {
                f"{phase}_ms": sum(a.elapsed_time(b) for a, b in spans)
                for phase, spans in (("copy_in", timing["in"]), ("update", timing["update"]),
                                     ("copy_out", timing["out"]))
            }
            self.split.update(bytes_in=nbytes["in"], bytes_out=nbytes["out"], units=len(units))
