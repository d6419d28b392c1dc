"""Tee stdout/stderr + logging to a per-run log file.

Counterpart of `llm_training_tpu/callbacks/output_redirection.py`
(standard library only; a dataclass config): numbered `.log` files in
`log_dir`, the tee installed at fit start and removed at fit end -- and by
`teardown`, which the trainer calls even when the fit raises.
"""

from __future__ import annotations

import logging
import sys
from dataclasses import dataclass
from pathlib import Path


@dataclass
class OutputRedirectionConfig:
    log_dir: str = "runs/logs"


class _Tee:
    def __init__(self, stream, sink):
        self._stream = stream
        self._sink = sink

    def write(self, data):
        self._stream.write(data)
        self._sink.write(data)
        return len(data)

    def flush(self):
        self._stream.flush()
        self._sink.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


class OutputRedirection:
    """Installs the tee at fit start; removes it (and closes the file) at
    fit end. Files are numbered `0.log`, `1.log`, ... per directory, like
    JAX's."""

    def __init__(self, config: OutputRedirectionConfig | None = None):
        self.config = config or OutputRedirectionConfig()
        self._file = None
        self._saved = None
        self.log_path: Path | None = None

    def on_fit_start(self, trainer, objective, datamodule, start_step) -> None:
        log_dir = Path(self.config.log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        taken = [
            int(p.stem) for p in log_dir.glob("*.log") if p.stem.isdigit()
        ]
        n = max(taken, default=-1) + 1  # gaps never clobber an existing log
        self.log_path = log_dir / f"{n}.log"
        self._file = open(self.log_path, "w")
        self._saved = (sys.stdout, sys.stderr)
        sys.stdout = _Tee(self._saved[0], self._file)
        sys.stderr = _Tee(self._saved[1], self._file)
        # loggers don't necessarily write through sys.stdout/stderr (their
        # handlers may hold other streams), so tee them with a real handler
        self._handler = logging.StreamHandler(self._file)
        self._handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        logging.getLogger().addHandler(self._handler)

    def on_fit_end(self, trainer, state) -> None:
        self.teardown()

    def teardown(self) -> None:
        """Idempotent; also invoked by the trainer's finally block so a
        raising fit cannot leak the tee or the extra root handler."""
        if self._saved is not None:
            logging.getLogger().removeHandler(self._handler)
            self._handler = None
            sys.stdout, sys.stderr = self._saved
            self._saved = None
        if self._file is not None:
            self._file.close()
            self._file = None
