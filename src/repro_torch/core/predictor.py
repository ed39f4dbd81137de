"""Learned service-time predictor (paper §3.2, after Neurosurgeon [22]).

"For model-based prediction, a neural network can be trained to predict the
service time of a model on a given hardware ... in our experiments we adopt a
simple neural network from [22]."

A small float32 MLP maps workload features (log-FLOPs, log-params,
log-payload, batch, sequence length) to log10 service time. It is the port's
twin of ``repro.core.predictor``: the same He-normal init (drawn from a
``torch.Generator`` seeded from ``seed``; ``models.convert.
predictor_params_from_jax`` carries the reference's init across instead), the
same tanh-approximated GELU (``jax.nn.gelu``'s default), the same hand-written
Adam in the same order, and the same minibatch indices (one
``rng.integers(0, n, size=min(batch_size, n))`` per step from
``np.random.default_rng(seed)``). Training runs on ``device``, the card unless
the caller asks for the CPU: the standardised features and targets are copied
there once, the indices once, the Adam update runs as one multi-tensor
operation per term, and the loss is read once, at the end.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

__all__ = ["LatencyPredictor", "workload_features"]


def workload_features(
    flops: float, param_bytes: float, act_bytes: float, batch: int, seq: int
) -> np.ndarray:
    """Canonical feature vector; logs tame the dynamic range (1e6..1e15)."""
    return np.array(
        [
            np.log10(max(flops, 1.0)),
            np.log10(max(param_bytes, 1.0)),
            np.log10(max(act_bytes, 1.0)),
            np.log10(max(batch, 1)),
            np.log10(max(seq, 1)),
        ],
        dtype=np.float32,
    )


def minibatch_indices(n: int, steps: int, batch_size: int, seed: int) -> np.ndarray:
    """(steps, min(batch_size, n)) row indices: the reference's per-step draws,
    made one call per step as it makes them (a single (steps, batch) call is
    another stream: numpy's bounded draws discard per call what they do not
    use)."""
    rng = np.random.default_rng(seed)
    size = min(batch_size, n)
    draws = [rng.integers(0, n, size=size) for _ in range(steps)]
    return np.array(draws, dtype=np.int64).reshape(steps, size)


def _loss(model: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((model(x) - y) ** 2)


class LatencyPredictor(nn.Module):
    """MLP: standardized features -> log10(service seconds)."""

    def __init__(self, n_features: int = 5, hidden: Sequence[int] = (64, 64), seed: int = 0,
                 *, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.sizes = [n_features, *hidden, 1]
        gen = torch.Generator().manual_seed(seed)
        ws, bs = [], []
        for fan_in, fan_out in zip(self.sizes[:-1], self.sizes[1:]):
            w = torch.randn((fan_in, fan_out), generator=gen) * np.sqrt(2.0 / fan_in)
            ws.append(nn.Parameter(w.to(torch.float32)))
            bs.append(nn.Parameter(torch.zeros(fan_out, dtype=torch.float32)))
        self.w = nn.ParameterList(ws)
        self.b = nn.ParameterList(bs)
        self.to(self.device)
        self._mu = np.zeros(n_features, np.float32)
        self._sigma = np.ones(n_features, np.float32)
        self._fitted = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Standardised (N, F) features -> (N,) log10 seconds."""
        n = len(self.w)
        for i in range(n):
            x = x @ self.w[i] + self.b[i]
            if i < n - 1:
                x = F.gelu(x, approximate="tanh")
        return x[..., 0]

    # ------------------------------------------------------------------
    def fit(
        self,
        features: np.ndarray,
        latencies_s: np.ndarray,
        *,
        steps: int = 2000,
        lr: float = 1e-3,
        batch_size: int = 256,
        seed: int = 0,
    ) -> float:
        """Train on (N, F) features vs (N,) latencies. Returns final MSE (log-space)."""
        x = np.asarray(features, np.float32)
        y = np.log10(np.maximum(np.asarray(latencies_s, np.float32), 1e-9))
        if x.ndim != 2 or x.shape[0] != y.shape[0]:
            raise ValueError("features must be (N,F) matching latencies (N,)")
        self._mu = x.mean(axis=0)
        self._sigma = x.std(axis=0) + 1e-6
        xn = (x - self._mu) / self._sigma

        dev = self.device
        xs = torch.from_numpy(np.ascontiguousarray(xn)).to(dev)
        ys = torch.from_numpy(np.ascontiguousarray(y)).to(dev)
        idx = torch.from_numpy(minibatch_indices(xn.shape[0], steps, batch_size, seed)).to(dev)
        params = list(self.parameters())
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        b1, b2, eps = 0.9, 0.999, 1e-8
        loss = torch.full((), np.inf)
        for t in range(1, steps + 1):
            rows = idx[t - 1]
            loss = _loss(self, xs[rows], ys[rows])
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                # the reference's update, m = b1 m + (1 - b1) g, v = b2 v +
                # (1 - b2) g g, p -= lr m^ / (sqrt(v^) + eps), each operation
                # once over all layers (the same arithmetic per element)
                torch._foreach_mul_(m, b1)
                torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
                gg = torch._foreach_mul(grads, 1 - b2)
                torch._foreach_mul_(gg, grads)
                torch._foreach_mul_(v, b2)
                torch._foreach_add_(v, gg)
                mh = torch._foreach_div(m, 1 - b1**t)
                den = torch._foreach_div(v, 1 - b2**t)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, eps)
                torch._foreach_mul_(mh, lr)
                torch._foreach_div_(mh, den)
                torch._foreach_sub_(params, mh)
        self._fitted = True
        return float(loss.detach())

    # ------------------------------------------------------------------
    def predict(self, features: np.ndarray) -> np.ndarray:
        """Predicted service seconds for (N, F) or (F,) features."""
        if not self._fitted:
            raise RuntimeError("predictor not fitted")
        x = np.atleast_2d(np.asarray(features, np.float32))
        xn = (x - self._mu) / self._sigma
        with torch.no_grad():
            logs = self(torch.from_numpy(np.ascontiguousarray(xn)).to(self.device)).cpu().numpy()
        out = 10.0**logs
        return out if out.shape[0] > 1 else out[0]

    def mape(self, features: np.ndarray, latencies_s: np.ndarray) -> float:
        pred = np.atleast_1d(self.predict(features))
        obs = np.asarray(latencies_s, np.float64)
        return float(np.mean(np.abs(pred - obs) / obs) * 100.0)
