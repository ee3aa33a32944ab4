"""Adam and SGD as optax computes them (`optax.adam` / `optax.sgd` in the
JAX package's optimize(), drtvam_tpu/opt/optimize.py:496-503, :569-574),
written as a few tensor operations on the device.

The update rules are optax 0.2's `scale_by_adam` and `trace`, chained
with `scale_by_learning_rate`, at its rounding points: the moments are
exponential moving averages in float32, the bias corrections
1 - b**count are float32 scalars, the step is
mu_hat / (sqrt(nu_hat + eps_root) + eps) times -lr, and the patterns are
clamped at 0 after it, as optimize() clamps them. torch.optim's Adam is
not used: it has no eps_root and divides by sqrt(v) / sqrt(bc2) + eps,
which rounds differently.

The state is optax's, leaf for leaf and in its order (a checkpoint of
either package restores into the other):
  * adam: count (int32 scalar), mu, nu;
  * sgd: no leaf, or with `momentum` one leaf, the trace.
"""
from __future__ import annotations

import numpy as np
import torch

# optax's defaults: the learning rate the JAX package gives each when
# the config names none, and the keys each accepts
DEFAULT_LR = {"adam": 0.01, "sgd": 0.1}
KEYS = {"adam": {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
                 "nesterov": False},
        "sgd": {"momentum": None, "nesterov": False}}
_INT32_MAX = np.iinfo(np.int32).max


def _bias_correction(decay, count):
    """1 - decay**count in float32, as optax's bias_correction."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class FirstOrder:
    """optax.adam / optax.sgd on one device, stepped by optimize().

    kind: 'adam' or 'sgd'; lr: the learning rate (optax's default when
    None); options: the optimizer config's other keys (KEYS)."""

    def __init__(self, kind, lr=None, **options):
        if kind not in KEYS:
            raise ValueError(f"Unknown optimizer type: '{kind}'")
        unknown = sorted(set(options) - set(KEYS[kind]))
        if unknown:
            raise ValueError(f"optimizer '{kind}' takes no keys {unknown} "
                             f"(it takes lr and {sorted(KEYS[kind])})")
        self.kind = kind
        self.lr = DEFAULT_LR[kind] if lr is None else float(lr)
        self.opts = {**KEYS[kind], **options}
        self.state = None

    def init(self, p):
        """optax's tx.init(p): zero moments (a zero trace), count 0; the
        first step calls it."""
        if self.kind == "adam":
            self.state = [0, torch.zeros_like(p), torch.zeros_like(p)]
        elif self.opts["momentum"] is not None:
            self.state = [torch.zeros_like(p)]
        else:
            self.state = []

    def update(self, p, g):
        """optax's tx.update: the update (-lr times the rule's direction)
        of parameters p at gradient g, the state advanced."""
        if self.state is None:
            self.init(p)
        u = self._adam(g) if self.kind == "adam" else self._sgd(g)
        return u * (-self.lr)

    def step(self, p, g):
        """One optax update and apply_updates, then the clamp at 0.
        Returns the new patterns."""
        return torch.clamp(p + self.update(p, g), min=0.0)

    def _adam(self, g):
        o = self.opts
        b1, b2 = o["b1"], o["b2"]
        count, mu, nu = self.state
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        count = min(count + 1, _INT32_MAX)
        if o["nesterov"]:
            nxt = min(count + 1, _INT32_MAX)
            mu_hat = b1 * (mu / _bias_correction(b1, nxt)) + \
                (1 - b1) * (g / _bias_correction(b1, count))
        else:
            mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        self.state = [count, mu, nu]
        return mu_hat / (torch.sqrt(nu_hat + o["eps_root"]) + o["eps"])

    def _sgd(self, g):
        if not self.state:
            return g
        m = self.opts["momentum"]
        trace = g + m * self.state[0]
        self.state = [trace]
        return g + m * trace if self.opts["nesterov"] else trace

    # -- checkpointing: optax's leaves ---------------------------------------

    def leaves(self):
        """The state as numpy, in optax's leaf order."""
        if self.state is None:
            raise ValueError("the optimizer has not been initialized")
        out = []
        for leaf in self.state:
            if torch.is_tensor(leaf):
                out.append(leaf.detach().cpu().numpy())
            else:
                out.append(np.int32(leaf))
        return out

    def load_leaves(self, leaves, p):
        """Restore optax leaves (either package's) onto p's device; p
        gives the shape every vector leaf must have."""
        self.init(p)
        if len(leaves) != len(self.state):
            raise ValueError(f"the checkpoint holds {len(leaves)} optimizer "
                             f"leaves, '{self.kind}' with these options has "
                             f"{len(self.state)}")
        for i, leaf in enumerate(leaves):
            leaf = np.asarray(leaf)
            if torch.is_tensor(self.state[i]):
                if leaf.shape != tuple(p.shape):
                    raise ValueError(f"optimizer leaf {i} has shape "
                                     f"{leaf.shape}, the patterns "
                                     f"{tuple(p.shape)}")
                self.state[i] = torch.as_tensor(
                    np.array(leaf, np.float32), device=p.device)
            else:
                self.state[i] = int(leaf)
