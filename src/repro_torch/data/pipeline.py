"""Data pipeline: deterministic synthetic stream + memmap token shards.

The batches are numpy, made as the reference pipeline makes them
(``repro.data.pipeline``): the synthetic stream is seeded by the step
(``Philox(key=step)``), so the same step gives the same tokens in both
packages and a restart from a checkpointed cursor reproduces the stream.
The loader cursor is a plain integer that rides the checkpoint; a
double-buffered prefetch thread hides host latency. One process reads the
whole global batch (the reference's host slice on one host).

Moving a batch to the card is an explicit step, :func:`to_device`, which
stages through pinned memory and copies without a host synchronisation.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    kind: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None       # token file for memmap
    d_model: int = 0                 # for embeds-input archs (stub frontends)
    input_mode: str = "tokens"       # tokens | embeds | encdec
    mrope: bool = False


class Pipeline:
    """Checkpointable batch source."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        if cfg.kind == "memmap":
            if not cfg.path:
                raise ValueError("memmap pipeline needs a token file")
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")

    # ---- state for checkpointing ------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step}

    def load_state_dict(self, d: Dict[str, Any]):
        self.step = int(d["step"])

    # ---- batch generation ---------------------------------------------------
    def _synthetic(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=step))
        toks = rng.integers(0, cfg.vocab, (cfg.global_batch, cfg.seq_len + 1),
                            dtype=np.int32)
        batch: Dict[str, np.ndarray] = {
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}
        B = toks.shape[0]
        if cfg.input_mode == "embeds":
            batch["embeds"] = rng.standard_normal(
                (B, cfg.seq_len, cfg.d_model), dtype=np.float32)
            if cfg.mrope:
                batch["positions"] = np.broadcast_to(
                    np.arange(cfg.seq_len, dtype=np.int32)[None, None],
                    (3, B, cfg.seq_len)).copy()
            batch.pop("tokens")
        elif cfg.input_mode == "encdec":
            batch["src_embeds"] = rng.standard_normal(
                (B, cfg.seq_len, cfg.d_model), dtype=np.float32)
        return batch

    def _memmap(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        span = cfg.seq_len + 1
        n_windows = (len(self._tokens) - 1) // span
        base = (step * cfg.global_batch) % max(n_windows - cfg.global_batch, 1)
        rows = []
        for i in range(cfg.global_batch):
            off = ((base + i) % n_windows) * span
            rows.append(np.asarray(self._tokens[off:off + span]))
        toks = np.stack(rows)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def next(self) -> Dict[str, np.ndarray]:
        fn = self._synthetic if self.cfg.kind == "synthetic" else self._memmap
        batch = fn(self.step)
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()


class Prefetcher:
    """Double-buffered background prefetch (hides host batch creation)."""

    def __init__(self, pipeline: Pipeline, depth: int = 2):
        self.pipeline = pipeline
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        while not self._stop.is_set():
            batch = self.pipeline.next()
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)


def to_device(batch: Dict[str, np.ndarray], device=None):
    """A numpy batch as tensors on ``device`` (``None`` = the card; raises
    without one). On the card each array is staged in pinned memory and
    copied asynchronously, so the transfer makes no host synchronisation."""
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def write_token_file(path: str, tokens: np.ndarray):
    np.asarray(tokens, np.int32).tofile(path)
