"""Step constructors, input specs and their sharding axes: the port of
``repro.launch.steps``, the contract between models, launchers and the dry run.

``batch_specs`` and ``decode_specs`` give each input of a cell's step as
(shape, dtype), allocating nothing; ``batch_axes`` and ``decode_axes`` give
their logical sharding axes. ``make_train_step`` builds the training step:
the loss and its gradients (with the reference's ``grad_accum`` microbatch
loop and its accumulator in ``cfg.grad_dtype``), the optional int8 gradient
compression, then Adafactor or AdamW; the model's parameters are updated in
place. ``make_prefill_step`` and ``make_decode_step`` call the model's
serving entry points as the reference's steps do.

``cell_step_and_specs`` assembles one (arch x shape) cell: the step, the
specs of its inputs and their axes, keyed alike ("params" by the port's
per-layer parameter names). ``shardings_for`` resolves an axes tree to DTensor
placements under a ``ShardingRules``. The dry-run launchers build fake
DTensors from those and run the step once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import lm
from repro_torch.models.params import map_axes, torch_dtype, tree_map
from repro_torch.sharding.partition import ShardingRules, current_rules
from repro_torch.training import optimizer as opt

__all__ = [
    "prefix_len",
    "batch_specs",
    "decode_specs",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
    "param_specs",
    "param_axes",
    "batch_axes",
    "decode_axes",
    "Cell",
    "cell_step_and_specs",
    "shardings_for",
]

I32 = torch.int32


def prefix_len(cfg: ModelConfig, seq_len: int) -> int:
    if not cfg.prefix_embed or cfg.is_encdec:
        return 0
    return int(seq_len * cfg.prefix_len_fraction)


def batch_specs(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    """Training / prefill batch: name -> (shape, dtype)."""
    B, S = shape.global_batch, shape.seq_len
    d = torch_dtype(cfg.dtype)
    if cfg.is_encdec:
        return {"enc_embeds": ((B, S, cfg.d_model), d), "tokens": ((B, S), I32),
                "targets": ((B, S), I32), "loss_mask": ((B, S), torch.float32)}
    P = prefix_len(cfg, S)
    text = S - P
    out = {"tokens": ((B, text), I32), "targets": ((B, text), I32),
           "loss_mask": ((B, text), torch.float32)}
    if P:
        out["prefix_embeds"] = ((B, P, cfg.d_model), d)
    return out


def batch_axes(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    ax2 = ("batch", None)
    out = {k: ax2 for k in ("tokens", "targets", "loss_mask")}
    if cfg.is_encdec:
        out["enc_embeds"] = ("batch", None, None)
    elif prefix_len(cfg, shape.seq_len):
        out["prefix_embeds"] = ("batch", None, None)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    """Decode-step inputs: one new token, the position, and caches holding
    ``seq_len`` positions, each as (shape, dtype)."""
    B, S = shape.global_batch, shape.seq_len
    d = torch_dtype(cfg.dtype)
    caches = tree_map(lambda _, leaf: (leaf.shape, torch_dtype(leaf.dtype) if leaf.dtype else d),
                      lm.cache_template(cfg, B, S, enc_len=S if cfg.is_encdec else 0))
    return {"token": ((B, 1), I32), "pos": ((), I32), "caches": caches}


def decode_axes(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    cache_ax = tree_map(lambda _, leaf: tuple(leaf.axes), lm.cache_template(
        cfg, shape.global_batch, shape.seq_len, enc_len=shape.seq_len if cfg.is_encdec else 0))
    return {"token": ("batch", None), "pos": (), "caches": cache_ax}


def param_specs(cfg: ModelConfig) -> dict:
    """name -> (shape, dtype) of each of the model's parameters."""
    d = torch_dtype(cfg.dtype)
    return {k: (leaf.shape, torch_dtype(leaf.dtype) if leaf.dtype else d)
            for k, leaf in lm.param_templates(cfg).items()}


def param_axes(cfg: ModelConfig) -> dict:
    """name -> logical axes of each of the model's parameters."""
    return {k: tuple(leaf.axes) for k, leaf in lm.param_templates(cfg).items()}


def make_train_step(cfg: ModelConfig, ocfg=None) -> Callable:
    """``step(model, opt_state, batch) -> metrics``: one optimizer step on
    ``model`` in place (its parameters set to require grad). ``opt_state``
    comes from ``adamw_init`` or ``adafactor_init`` over
    ``dict(model.named_parameters())``, and is updated in place."""
    if ocfg is None:
        ocfg = opt.AdafactorConfig() if cfg.optimizer == "adafactor" else opt.AdamWConfig()
    is_adafactor = isinstance(ocfg, opt.AdafactorConfig)
    gd = torch_dtype(cfg.grad_dtype)

    def compute_grads(model, params: dict, batch: dict):
        A = max(1, cfg.grad_accum)
        if A == 1:
            loss, metrics = lm.loss_fn(model, batch)
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
                {k: p.grad.to(gd) for k, p in params.items()}
        # gradient accumulation: A microbatches, the accumulator in grad_dtype
        mbs = [{k: x.reshape(A, x.shape[0] // A, *x.shape[1:])[i] for k, x in batch.items()}
               for i in range(A)]
        acc = {k: torch.zeros(p.shape, dtype=gd, device=p.device) for k, p in params.items()}
        loss_sum = tok_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in mbs:
            for p in params.values():
                p.grad = None
            loss, metrics = lm.loss_fn(model, mb)
            loss.backward()
            for k, p in params.items():
                acc[k] += p.grad.to(gd)
            loss_sum = loss_sum + loss.detach()
            tok_sum = tok_sum + metrics["tokens"]
        loss = loss_sum / A
        return loss, {"loss": loss, "nll": loss, "tokens": tok_sum}, \
            {k: g / A for k, g in acc.items()}

    def train_step(model, opt_state: dict, batch: dict) -> dict:
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, metrics, grads = compute_grads(model, params, batch)
        for p in params.values():
            p.grad = None  # the cast copies in ``grads`` are what the update reads
        groups = lm.stack_groups(cfg, params)
        if not is_adafactor and ocfg.compress:
            q, scales, new_err = opt.compress_grads(grads, opt_state.get("ef"), groups)
            grads = opt.decompress_grads(q, scales)
        with torch.no_grad():
            if is_adafactor:
                new_params, opt_state, om = opt.adafactor_update(ocfg, grads, opt_state, params,
                                                                 groups)
            else:
                new_params, opt_state, om = opt.adamw_update(ocfg, grads, opt_state, params)
                if ocfg.compress:
                    opt_state["ef"] = new_err
            for k, p in params.items():
                p.copy_(new_params[k])
        return dict(metrics, **om)

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(model, batch: dict):
        return model.prefill(batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
                             enc_embeds=batch.get("enc_embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(model, token, pos, caches):
        return model.decode_step(token, pos, caches)

    return decode_step


# ---------------------------------------------------------------------------
# Cell assembly: (step fn, input specs, logical axes) for one (arch x shape)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Cell:
    step: Callable
    specs: dict  # input name -> tree of (shape, dtype)
    axes: dict  # matching logical axes
    kind: str


def cell_step_and_specs(cfg: ModelConfig, shape: ShapeSuite, *, zero_size: int = 0) -> Cell:
    """The step of one cell with its inputs' specs and axes. Train:
    ``step(model, opt_state, batch)``; prefill: ``step(model, batch)``;
    decode: ``step(model, token, pos, caches)``; "params" are the model's."""
    p_specs, p_axes = param_specs(cfg), param_axes(cfg)
    if shape.kind == "train":
        rules = current_rules()

        def _uses_data(v) -> bool:
            return v == "data" or (isinstance(v, tuple) and "data" in v)

        if rules is not None:
            replicated = frozenset(k for k, v in rules.rules.items() if v is None)
            data_resident = frozenset(k for k, v in rules.rules.items() if _uses_data(v))
        else:
            replicated = frozenset({"embed"})
            data_resident = frozenset({"expert_ff", "zero"})
        if cfg.optimizer == "adafactor":
            ostate = opt.abstract_adafactor_state(p_specs)
            oaxes = opt.adafactor_axes(p_axes, p_specs)
        else:
            ostate = opt.abstract_adamw_state(p_specs)
            oaxes = opt.opt_axes(p_axes, p_specs, zero_size=zero_size,
                                 replicated_names=replicated, data_resident_names=data_resident)
        return Cell(step=make_train_step(cfg),
                    specs={"params": p_specs, "opt_state": ostate,
                           "batch": batch_specs(cfg, shape)},
                    axes={"params": p_axes, "opt_state": oaxes, "batch": batch_axes(cfg, shape)},
                    kind="train")
    if shape.kind == "prefill":
        return Cell(step=make_prefill_step(cfg),
                    specs={"params": p_specs, "batch": batch_specs(cfg, shape)},
                    axes={"params": p_axes, "batch": batch_axes(cfg, shape)},
                    kind="prefill")
    if shape.kind == "decode":
        d, da = decode_specs(cfg, shape), decode_axes(cfg, shape)
        return Cell(step=make_decode_step(cfg),
                    specs={"params": p_specs, "token": d["token"], "pos": d["pos"],
                           "caches": d["caches"]},
                    axes={"params": p_axes, "token": da["token"], "pos": da["pos"],
                          "caches": da["caches"]},
                    kind="decode")
    raise ValueError(shape.kind)


def shardings_for(axes_tree: Any, rules: ShardingRules):
    """Logical axes tree -> tree of DTensor placements (one per mesh dim)."""
    return map_axes(rules.placements, axes_tree)
