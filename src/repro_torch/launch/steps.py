"""Step constructors and input specs: the port of ``repro.launch.steps``, in part.

``batch_specs`` and ``decode_specs`` give each input of a cell's step as
(shape, dtype), allocating nothing. ``make_train_step`` builds the training
step: the loss and its gradients (with the reference's ``grad_accum``
microbatch loop and its accumulator in ``cfg.grad_dtype``), the optional int8
gradient compression, then Adafactor or AdamW; the model's parameters are
updated in place. ``make_prefill_step`` and ``make_decode_step`` call the
model's serving entry points as the reference's steps do.

Not ported yet (ROADMAP A11b): ``cell_step_and_specs``, ``batch_axes``,
``decode_axes`` and ``shardings_for``, which need the logical sharding axes.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSuite
from repro_torch.models import lm
from repro_torch.models.params import torch_dtype, tree_map
from repro_torch.training import optimizer as opt

__all__ = [
    "prefix_len",
    "batch_specs",
    "decode_specs",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
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


def decode_specs(cfg: ModelConfig, shape: ShapeSuite) -> dict:
    """Decode-step inputs: one new token, the position, and caches holding
    ``seq_len`` positions, each as (shape, dtype)."""
    B, S = shape.global_batch, shape.seq_len
    d = torch_dtype(cfg.dtype)
    caches = tree_map(lambda _, leaf: (leaf.shape, torch_dtype(leaf.dtype) if leaf.dtype else d),
                      lm.cache_template(cfg, B, S, enc_len=S if cfg.is_encdec else 0))
    return {"token": ((B, 1), I32), "pos": ((), I32), "caches": caches}


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
