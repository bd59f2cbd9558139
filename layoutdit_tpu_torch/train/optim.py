"""The JAX trainer's optimizer, optax's chain written out in torch (port
of ``make_optimizer`` and ``make_lr_schedule``,
``layoutdit_tpu/train/trainer.py``).

The chain, in optax's order: ``clip_by_global_norm`` (when
``grad_clip_norm`` > 0), then ``adamw`` (``scale_by_adam`` with b1 0.9,
b2 0.999, eps 1e-8 and the first moment stored in ``adam_mu_dtype``;
``add_decayed_weights``; ``scale_by_learning_rate`` of the schedule),
all inside ``apply_if_finite`` when ``skip_nonfinite_updates`` > 0. Its
state is a plain dict of tensors on the parameters' device:

  * ``mu``, ``nu``: lists of moments, one per parameter (``mu`` float32
    or bfloat16, ``nu`` float32);
  * ``count`` (adam's, for the bias correction) and ``schedule_count``
    (the learning rate's), int32 scalars;
  * ``notfinite_count`` (consecutive non-finite updates) and
    ``total_notfinite``, int32 scalars, with ``apply_if_finite`` only;
  * ``trainable``, a bool per parameter, with a LoRA mask only (JAX's
    ``optax.masked`` around the chain): the moments, the clip norm and
    the updates cover the trainable parameters alone; a frozen one has
    no moments and never changes, weight decay included.

Every count stays on the device and the update reads nothing back to
the host. The arithmetic follows optax step by step, so that float32
and bf16 moments round as the JAX trainer's compiled step rounds them:
with a bf16 ``mu``, b1 meets it rounded to bf16 (0.8984375, JAX's weak
typing), while XLA takes the product and the sum with ``(1 - b1) g`` in
float32 and rounds ``mu`` to bf16 once, for storage (JAX run op by op
would round the product to bf16 too). The update is ``mu_hat /
(sqrt(nu_hat) + eps) + weight_decay * p`` (optax's order, not torch's
decoupled decay) and the parameters move by ``-lr`` times it. A rejected (non-finite)
update changes no parameter, moment or count but the two non-finite
counters; after ``skip_nonfinite_updates`` consecutive rejections the
update is applied anyway, so a diverged run fails loudly.
"""

from __future__ import annotations

import math

import torch

from layoutdit_tpu_torch.config import TrainingConfig

B1, B2, EPS = 0.9, 0.999, 1e-8
# b1 as JAX's weak typing meets a bf16 moment: rounded to bf16
B1_BF16 = 0.8984375


def make_lr_schedule(train_cfg: TrainingConfig, steps_per_epoch: int):
    """Update count -> learning rate, the JAX trainer's values, in float32
    on the count's device (an int count gives a CPU scalar): ``step`` =
    lr * gamma^(epoch // step_size) with epoch = count // steps_per_epoch;
    ``cosine`` = half-cosine decay to 0 over the run; either times
    min(1, (count + 1) / warmup_steps) when warming up."""

    def lr_schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        if train_cfg.lr_schedule == "cosine":
            total = max(1, train_cfg.num_epochs * steps_per_epoch)
            t = torch.clamp(count, max=total) / total
            base = train_cfg.learning_rate * 0.5 * (1 + torch.cos(math.pi * t))
        else:
            epoch = torch.div(count, max(1, steps_per_epoch), rounding_mode="floor")
            exponent = torch.div(epoch, train_cfg.step_size, rounding_mode="floor")
            base = train_cfg.learning_rate * torch.pow(
                torch.tensor(train_cfg.gamma, dtype=torch.float32, device=count.device),
                exponent.float())
        if train_cfg.warmup_steps > 0:
            base = base * torch.clamp((count + 1) / train_cfg.warmup_steps, max=1.0)
        return base

    return lr_schedule


class AdamW:
    """``make_optimizer`` of the JAX trainer: ``init(params, trainable)``
    gives the state, ``update(state, params, grads)`` applies one step in
    place (``params`` and the state's tensors). With a ``trainable`` mask
    (``models/lora.py``), ``update`` takes the trainable parameters and
    their gradients only, in order."""

    def __init__(self, train_cfg: TrainingConfig, steps_per_epoch: int):
        self.clip = train_cfg.grad_clip_norm
        self.weight_decay = train_cfg.weight_decay
        self.max_errors = train_cfg.skip_nonfinite_updates
        self.mu_dtype = (torch.bfloat16 if train_cfg.adam_mu_dtype == "bfloat16"
                         else torch.float32)
        self.lr_schedule = make_lr_schedule(train_cfg, steps_per_epoch)

    def init(self, params: list[torch.Tensor], trainable: list[bool] | None = None) -> dict:
        device = params[0].device
        mask = None
        if trainable is not None:
            mask = torch.tensor(trainable, dtype=torch.bool, device=device)
            params = [p for p, m in zip(params, trainable, strict=True) if m]

        def count():
            return torch.zeros((), dtype=torch.int32, device=device)

        state = {
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in params],
            "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "count": count(),
            "schedule_count": count(),
        }
        if self.max_errors > 0:
            state.update(notfinite_count=count(), total_notfinite=count())
        if mask is not None:
            state["trainable"] = mask
        return state

    @torch.no_grad()
    def update(self, state: dict, params: list[torch.Tensor],
               grads: list[torch.Tensor]) -> None:
        """One step from float32 ``grads``; the parameters change in place
        and the state's entries are replaced."""
        accept = None
        if self.max_errors > 0:
            # optax apply_if_finite: every gradient element finite. 0 * g is
            # 0 where g is finite and NaN where it is not, and a sum keeps
            # a NaN, so each norm is 0 exactly when its leaf is finite
            finite = (torch.stack(torch._foreach_norm(torch._foreach_mul(grads, 0.0))) == 0).all()
            zero = torch.zeros_like(state["notfinite_count"])
            state["notfinite_count"] = torch.where(finite, zero, state["notfinite_count"] + 1)
            state["total_notfinite"] = torch.where(
                finite, state["total_notfinite"], state["total_notfinite"] + 1)
            accept = finite | (state["notfinite_count"] > self.max_errors)
        if self.clip > 0:
            # optax clip_by_global_norm: t if ||g|| < max else t / ||g|| * max
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            clipped = torch._foreach_mul(torch._foreach_div(grads, norm), self.clip)
            keep = norm < self.clip
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

        # scale_by_adam: mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        if self.mu_dtype == torch.bfloat16:
            decayed = torch._foreach_mul([m.float() for m in state["mu"]], B1_BF16)
        else:
            decayed = torch._foreach_mul(state["mu"], B1)
        mu = torch._foreach_mul(grads, 1 - B1)
        torch._foreach_add_(mu, decayed)
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2)
        torch._foreach_add_(nu, torch._foreach_mul(state["nu"], B2))
        count = state["count"] + 1
        bc1 = 1 - torch.pow(torch.tensor(B1, device=count.device), count.float())
        bc2 = 1 - torch.pow(torch.tensor(B2, device=count.device), count.float())
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, EPS)
        step = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        # add_decayed_weights, then scale_by_learning_rate
        if self.weight_decay:
            torch._foreach_add_(step, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(step, -self.lr_schedule(state["schedule_count"]))
        mu = [m.to(self.mu_dtype) for m in mu]

        if accept is None:
            torch._foreach_add_(params, step)
            state["mu"], state["nu"] = mu, nu
            state["count"] = count
            state["schedule_count"] = state["schedule_count"] + 1
            return
        # a rejected update keeps the parameters, moments and counts bit
        # for bit, with no host read of the decision
        for p, s in zip(params, step):
            p.copy_(torch.where(accept, p + s, p))
        state["mu"] = [torch.where(accept, new, old) for new, old in zip(mu, state["mu"])]
        state["nu"] = [torch.where(accept, new, old) for new, old in zip(nu, state["nu"])]
        state["count"] = torch.where(accept, count, state["count"])
        state["schedule_count"] = torch.where(
            accept, state["schedule_count"] + 1, state["schedule_count"])
