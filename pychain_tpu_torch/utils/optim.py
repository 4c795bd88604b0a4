"""The corpus recipe's optimizer: optax's
``apply_if_finite(chain(clip_by_global_norm(clip), adam(lr)),
max_consecutive_errors)`` (examples/train_corpus.py:362-366 of the JAX
package) on tensors, with no host synchronisation.

* The clip is optax's rule, not ``torch.nn.utils.clip_grad_norm_``'s:
  with g_norm = sqrt(sum of every gradient's squares), a gradient is
  scaled to ``g / g_norm * clip`` when ``g_norm >= clip`` and left as it
  is otherwise (PyTorch's scales by ``clip / (g_norm + 1e-6)``).
* Adam is ``optax.adam``'s arithmetic: moments ``(1 - b) g + b m``, bias
  corrections by ``1 - b ** count``, the update
  ``m_hat / (sqrt(v_hat) + eps)`` times ``-lr``.
* A step whose gradients are not all finite leaves the tensors, both
  moments and the step count as they are and counts itself in
  ``total_notfinite``; after ``max_consecutive_errors`` such steps in a
  row the next is applied anyway.

Every decision is a device tensor (``torch.where``), so ``step`` queues
its work and returns: reading ``total_notfinite`` is the only wait.
"""

from __future__ import annotations

import torch


class ClipAdam:
    """Clip-then-Adam over ``tensors`` (each a leaf that receives a
    ``.grad``), skipping non-finite updates.  ``clip <= 0`` leaves the
    gradients unclipped (``optax.adam`` alone inside the guard)."""

    def __init__(self, tensors, lr: float = 1e-3, clip: float = 5.0,
                 max_consecutive_errors: int = 25, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.tensors = list(tensors)
        if not self.tensors:
            raise ValueError("ClipAdam needs at least one tensor")
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.max_consecutive_errors = int(max_consecutive_errors)
        dev = self.tensors[0].device
        self.mu = [torch.zeros_like(t) for t in self.tensors]
        self.nu = [torch.zeros_like(t) for t in self.tensors]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int32, device=dev)

    def zero_grad(self) -> None:
        for t in self.tensors:
            t.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(t) if t.grad is None else t.grad
                 for t in self.tensors]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        notfinite = torch.where(finite, torch.zeros_like(self.count),
                                self.notfinite_count + 1)
        apply = finite | (notfinite > self.max_consecutive_errors)
        if self.clip > 0:
            norm = torch.sqrt(torch.stack([torch.sum(g * g)
                                           for g in grads]).sum())
            keep = norm < self.clip
            grads = [torch.where(keep, g, g / norm * self.clip)
                     for g in grads]
        count = self.count + 1
        c1 = 1.0 - torch.pow(self.b1, count.to(torch.float32))
        c2 = 1.0 - torch.pow(self.b2, count.to(torch.float32))
        for t, g, mu, nu in zip(self.tensors, grads, self.mu, self.nu):
            mu_new = (1.0 - self.b1) * g + self.b1 * mu
            nu_new = (1.0 - self.b2) * (g * g) + self.b2 * nu
            update = (mu_new / c1) / (torch.sqrt(nu_new / c2) + self.eps)
            t.copy_(torch.where(apply, t + (-self.lr) * update, t))
            mu.copy_(torch.where(apply, mu_new, mu))
            nu.copy_(torch.where(apply, nu_new, nu))
        self.count = torch.where(apply, count, self.count)
        self.notfinite_count = notfinite
        self.total_notfinite = self.total_notfinite + (~finite).to(
            torch.int32)

    def state_dict(self) -> dict:
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        for name in ("count", "notfinite_count", "total_notfinite"):
            setattr(self, name, state[name].to(self.count.device).clone())
