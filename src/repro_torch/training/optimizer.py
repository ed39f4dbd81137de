"""AdamW, Adafactor, LR schedules, gradient clipping and int8 gradient
compression: the port of ``repro.training.optimizer``.

Parameters, gradients and optimizer state are dicts of tensors keyed by the
model's parameter names (``model.named_parameters()``). The update runs
leaf by leaf with the reference's arithmetic, element by element:

  * AdamW keeps an fp32 master copy and fp32 moments; the new parameters are
    the master cast back to each parameter's dtype. The moments and the
    master are updated in place (the state is returned as well);
  * Adafactor (Shazeer & Stern, arXiv:1804.04235) keeps factored second
    moments (row and column means) for a matrix whose last two dims are both
    at least 128, no momentum and no master copy: dbrx and arctic use it;
  * ``compress_grads`` quantises g + e to int8 with a per-tensor scale and
    keeps the residual e (error feedback), ``decompress_grads`` undoes it.

The reference stacks a layer's parameters over its superblocks, so its
per-tensor statistics (Adafactor's update RMS and parameter RMS, the int8
scale) run over a whole stack: ``groups`` (name -> stack, from
``models.lm.stack_groups``) pools them alike (ROADMAP C14); without it
each leaf stands alone.

Scalars (the count, the learning rate, bias corrections) are computed in
float32 as the reference computes them, then applied as Python floats (an
exact conversion). ``abstract_*`` give the state's (shape, dtype) per leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = [
    "AdamWConfig", "AdafactorConfig", "cosine_schedule", "clip_by_global_norm",
    "adamw_init", "adamw_update", "abstract_adamw_state",
    "adafactor_init", "adafactor_update", "abstract_adafactor_state",
    "compress_grads", "decompress_grads",
]

F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[int], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress: bool = False  # int8 error-feedback gradient compression

    def lr_at(self, step: int) -> torch.Tensor:
        return _f32(self.lr(step) if callable(self.lr) else self.lr)


def cosine_schedule(peak: float, warmup: int, total: int, floor_frac: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor_frac * peak`` at ``total``; float32 throughout."""

    def lr(step) -> torch.Tensor:
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), the global norm): the norm
    over every leaf in fp32, each leaf returned in its own dtype."""
    total = torch.zeros((), dtype=F32, device=next(iter(grads.values())).device)
    for g in grads.values():
        total = total + g.float().square().sum()
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


def adamw_init(params: dict) -> dict:
    """fp32 master + moments (copies, never aliases); ``count`` is the step."""
    dev = next(iter(params.values())).device
    return {
        "master": {k: p.detach().to(F32, copy=True) for k, p in params.items()},
        "m": {k: torch.zeros(p.shape, dtype=F32, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def abstract_adamw_state(shapes: dict) -> dict:
    """``shapes``: name -> (shape, dtype) of each parameter."""
    f32 = {k: (tuple(s), F32) for k, (s, _) in shapes.items()}
    return {"master": f32, "m": dict(f32), "v": dict(f32), "count": ((), torch.int32)}


def adamw_update(cfg: AdamWConfig, grads: dict, state: dict, params: dict):
    """One AdamW step. Returns (new params in each parameter's dtype, the
    state (updated in place), {"grad_norm", "lr"})."""
    grads = {k: g.float() for k, g in grads.items()}
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=F32, device=state["count"].device)
    count = state["count"] + 1
    t = int(count)
    lr_t = cfg.lr_at(t)
    lr = float(lr_t)
    b1c = float(1.0 - _f32(cfg.b1) ** _f32(t))
    b2c = float(1.0 - _f32(cfg.b2) ** _f32(t))
    new_params = {}
    for k, g in grads.items():
        m, v, master = state["m"][k], state["v"][k], state["master"][k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        master.sub_(lr * (update + cfg.weight_decay * master))
        new_params[k] = master.to(params[k].dtype)
    state["count"] = count
    return new_params, state, {"grad_norm": gnorm, "lr": lr_t}


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

_FACTOR_MIN = 128  # factor only dims >= this (as in T5X)


@dataclass(frozen=True)
class AdafactorConfig:
    lr: float | Callable[[int], torch.Tensor] = 1e-2
    decay_exponent: float = 0.8  # beta2_t = 1 - t^-0.8
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def lr_at(self, step: int) -> torch.Tensor:
        return _f32(self.lr(step) if callable(self.lr) else self.lr)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= _FACTOR_MIN and shape[-2] >= _FACTOR_MIN


def _factor_shapes(shape) -> dict:
    shape = tuple(shape)
    if _factored(shape):
        return {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
    return {"v": shape}


def adafactor_init(params: dict) -> dict:
    return {
        "factors": {k: {n: torch.zeros(s, dtype=F32, device=p.device)
                        for n, s in _factor_shapes(p.shape).items()}
                    for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device),
    }


def abstract_adafactor_state(shapes: dict) -> dict:
    """``shapes``: name -> (shape, dtype) of each parameter."""
    return {"factors": {k: {n: (fs, F32) for n, fs in _factor_shapes(s).items()}
                        for k, (s, _) in shapes.items()},
            "count": ((), torch.int32)}


def _pooled_rms(values: dict, groups: dict | None) -> dict:
    """name -> sqrt(mean(x^2) over the name's group) (the leaf alone without
    ``groups``), in fp32, without the eps the caller adds."""
    groups = groups or {k: k for k in values}
    sums: dict = {}
    for k, x in values.items():
        s, n = sums.get(groups[k], (0.0, 0))
        sums[groups[k]] = (s + (x * x).sum(), n + x.numel())
    return {k: sums[groups[k]] for k in values}


def adafactor_update(cfg: AdafactorConfig, grads: dict, state: dict, params: dict,
                     groups: dict | None = None):
    """One Adafactor step. Returns (new params, the state (factors updated in
    place), {"lr"}). ``groups`` pools each stack's RMS statistics, as the
    reference's stacked leaves pool them."""
    count = state["count"] + 1
    t = int(count)
    beta2 = float(1.0 - _f32(t) ** (-cfg.decay_exponent))
    lr_t = cfg.lr_at(t)
    lr = float(lr_t)
    us = {}
    for k, g in grads.items():
        fac = state["factors"][k]
        gf = g.float()
        g2 = gf * gf + cfg.eps1
        if "vr" in fac:
            fac["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
            fac["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
            # v-hat = vr vc^T / mean(vr)
            denom = torch.clamp(fac["vr"].mean(dim=-1, keepdim=True), min=cfg.eps1)
            vhat = (fac["vr"] / denom)[..., None] * fac["vc"][..., None, :]
        else:
            vhat = fac["v"].mul_(beta2).add_((1 - beta2) * g2)
        us[k] = gf * torch.rsqrt(vhat + cfg.eps1)
    pf = {k: params[k].detach().float() for k in grads}
    u_sums, p_sums = _pooled_rms(us, groups), _pooled_rms(pf, groups)
    new_params = {}
    for k, u in us.items():
        # RMS clip
        s, n = u_sums[k]
        rms_u = torch.sqrt(s / n + cfg.eps1)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        # relative step: scale by max(eps2, RMS(param))
        s, n = p_sums[k]
        scale = torch.clamp(torch.sqrt(s / n), min=cfg.eps2)
        new_p = pf[k] - lr * scale * u
        if cfg.weight_decay:
            new_p = new_p - lr * cfg.weight_decay * pf[k]
        new_params[k] = new_p.to(params[k].dtype)
    state["count"] = count
    return new_params, state, {"lr": lr_t}


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------


def compress_grads(grads: dict, error: dict | None, groups: dict | None = None):
    """Quantise (g + e) to int8 with a per-tensor scale (one per group where
    ``groups`` is given); returns (q, scales, new_error), each a dict like
    ``grads``."""
    gf = {k: g.float() + (error[k] if error is not None else 0.0) for k, g in grads.items()}
    groups = groups or {k: k for k in gf}
    peak: dict = {}
    for k, x in gf.items():
        m = x.abs().max()
        peak[groups[k]] = m if groups[k] not in peak else torch.maximum(peak[groups[k]], m)
    q, scales, errs = {}, {}, {}
    for k, x in gf.items():
        scale = torch.clamp(peak[groups[k]], min=1e-12) / 127.0
        qi = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        q[k], scales[k], errs[k] = qi, scale, x - qi.float() * scale
    return q, scales, errs


def decompress_grads(q: dict, scales: dict) -> dict:
    return {k: qi.float() * scales[k] for k, qi in q.items()}
