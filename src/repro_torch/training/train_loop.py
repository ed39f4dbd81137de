"""Training loop: the train step, checkpoint / restart and the straggler
watchdog; the port of ``repro.training.train_loop``.

  * state = (model, optimizer state, step); a checkpoint holds the
    parameters by name, the optimizer state and nothing of the device, so
    ``resume()`` restores onto whatever device the trainer runs on;
  * the data pipeline is stateless by step, so restoring ``step`` resumes the
    exact token stream;
  * a per-step deadline watchdog implements the synchronous-SGD straggler
    policy: a step longer than ``deadline_factor`` x the median of the last
    32 (once 8 are in) is recorded in ``straggler_events``.

Each step's ``step_time_s`` is taken on the host clock after
``torch.cuda.synchronize()`` on the card (after reading the loss on the CPU).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import LM
from repro_torch.training import optimizer as opt

__all__ = ["TrainConfig", "Trainer"]


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 256
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    deadline_factor: float = 3.0  # straggler threshold vs median step time
    lr: float = 3e-4
    warmup: int = 20


class Trainer:
    """Single-process training loop on one device (the CUDA card when
    ``device`` is None)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *, ocfg=None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        if ocfg is None:
            if cfg.optimizer == "adafactor":
                ocfg = opt.AdafactorConfig(lr=tc.lr)
            else:
                ocfg = opt.AdamWConfig(lr=opt.cosine_schedule(tc.lr, tc.warmup, tc.steps))
        self.ocfg = ocfg
        self.data = SyntheticLM(cfg, DataConfig(batch=tc.batch, seq_len=tc.seq_len, seed=tc.seed),
                                device=self.device)
        self.step_fn = make_train_step(cfg, ocfg)
        self.ckpt = Checkpointer(tc.checkpoint_dir, keep=tc.keep) if tc.checkpoint_dir else None
        self.metrics_log: list[dict] = []
        self.straggler_events: list[dict] = []

    # ------------------------------------------------------------------
    def _init_opt(self, model: LM) -> dict:
        params = dict(model.named_parameters())
        if isinstance(self.ocfg, opt.AdafactorConfig):
            return opt.adafactor_init(params)
        return opt.adamw_init(params)

    def init_state(self, seed: int = 0):
        """(model with random weights from ``seed``, optimizer state, step 0)."""
        model = LM(self.cfg, device=self.device, seed=seed).requires_grad_(True)
        return model, self._init_opt(model), 0

    def resume(self, step: int | None = None):
        """(model, optimizer state, step) from checkpoint ``step`` (the
        latest when None), on the trainer's device."""
        if self.ckpt is None:
            raise ValueError("no checkpoint directory configured")
        step, tree = self.ckpt.restore(step, device=self.device)
        model = LM(self.cfg, device=self.device)
        model.load_state_dict(tree["params"], strict=True)
        return model.requires_grad_(True), tree["opt"], step

    def _save(self, step: int, model: LM, state: dict) -> None:
        params = {k: p.detach() for k, p in model.named_parameters()}
        self.ckpt.save(step, {"params": params, "opt": state})

    # ------------------------------------------------------------------
    def run(self, model: LM | None = None, state: dict | None = None, start_step: int = 0):
        """Train from ``start_step`` to ``tc.steps`` (from a fresh
        ``init_state(tc.seed)`` when no model is given). Returns (model,
        optimizer state, metrics_log)."""
        if model is None:
            model, state, start_step = self.init_state(self.tc.seed)
        on_card = self.device.type == "cuda"
        durations: list[float] = []
        for step in range(start_step, self.tc.steps):
            batch = self.data[step]
            t0 = time.perf_counter()
            metrics = self.step_fn(model, state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            if on_card:
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            durations.append(dt)
            # straggler watchdog
            if len(durations) >= 8:
                median = float(np.median(durations[-32:]))
                if dt > self.tc.deadline_factor * median:
                    self.straggler_events.append({"step": step, "duration": dt, "median": median})
            if step % self.tc.log_every == 0 or step == self.tc.steps - 1:
                rec["step"] = step
                rec["step_time_s"] = dt
                self.metrics_log.append(rec)
            if self.ckpt and (step + 1) % self.tc.checkpoint_every == 0:
                self._save(step + 1, model, state)
        if self.ckpt:
            self._save(self.tc.steps, model, state)
        return model, state, self.metrics_log
