"""Step factories: the train step (loss -> backward -> AdamW, with
microbatch gradient accumulation), prefill and one greedy decode step.

PyTorch runs eagerly, so a step is a closure over the architecture,
runtime config and dtype policy; there is nothing to jit.  The train
step is functional, as the reference's: it takes params and optimizer
state and returns new ones.  Gradients come from
``torch.autograd.grad`` over detached copies of the params marked
``requires_grad_()`` for the step, so nothing accumulates in ``.grad``
from one step to the next.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, RuntimeConfig
from repro_torch.dtensor_ops import argmax_last, placed_like
from repro_torch.models.common import (DTypePolicy, Params, named_leaves,
                                       tree_map)
from repro_torch.models.lm import decode_step, loss_fn, prefill
from repro_torch.optim import adamw


def loss_and_grads(params: Params, arch: ArchConfig,
                   batch: "dict[str, torch.Tensor]", rt: RuntimeConfig,
                   policy: DTypePolicy
                   ) -> "tuple[torch.Tensor, dict, Params]":
    """(loss, metrics, gradients in the params' layout and dtypes).  A
    param the loss does not reach gets a zero gradient, as under
    ``jax.grad``.  A DTensor param's gradient comes back in the param's
    placements (its data-parallel sums reduced), as the reference's
    gradients take the params' shardings."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, arch, batch, policy, rt=rt)
    flat = [t for _, t in named_leaves(leaves)]
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    of_leaf = {id(t): torch.zeros_like(t) if g is None else placed_like(g, t)
               for t, g in zip(flat, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: of_leaf[id(t)], leaves))


def make_train_step(arch: ArchConfig, rt: RuntimeConfig,
                    policy: DTypePolicy,
                    opt_cfg: "adamw.AdamWConfig | None" = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "lr", "grad_norm"})``.  With ``rt.accum_steps = a > 1``
    microbatch i is rows [i B/a, (i+1) B/a) of every batch tensor, as
    the reference's ``reshape(a, B // a, ...)`` splits them; the
    gradients are summed in ``policy.moments`` and divided by a, and the
    loss is the microbatches' mean."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        a = rt.accum_steps
        if a <= 1:
            loss, _, grads = loss_and_grads(params, arch, batch, rt, policy)
        else:
            def micro(x, i):
                n = x.shape[0] // a
                return x[i * n:(i + 1) * n]

            # zeros_like keeps a DTensor param's placements
            g_sum = tree_map(lambda p: torch.zeros_like(
                p, dtype=policy.moments), params)
            l_sum = torch.zeros((), dtype=torch.float32,
                                device=next(iter(batch.values())).device)
            for i in range(a):
                mb = {k: micro(v, i) for k, v in batch.items()}
                l, _, g = loss_and_grads(params, arch, mb, rt, policy)
                g_sum = _add_tree(g_sum, g, policy.moments)
                l_sum = l_sum + l
            grads = tree_map(lambda g: g / a, g_sum)
            loss = l_sum / a
        new_params, new_opt, stats = adamw.update(
            grads, opt_state, params, opt_cfg, policy)
        return new_params, new_opt, {"loss": loss, **stats}

    return train_step


def _add_tree(acc: Params, g: Params, dtype: torch.dtype) -> Params:
    return {k: _add_tree(v, g[k], dtype) if isinstance(v, dict)
            else v + g[k].to(dtype) for k, v in acc.items()}


def make_prefill_step(arch: ArchConfig, policy: DTypePolicy,
                      cache_len: int) -> Callable:
    def prefill_step(params, batch):
        return prefill(params, arch, batch, cache_len, policy)

    return prefill_step


def make_decode_step(arch: ArchConfig, policy: DTypePolicy, *,
                     mla_absorb: bool = False) -> Callable:
    """A greedy step: (next token [B, 1] int32, logits, cache).  The
    attention families update ``cache``'s tensors in place."""
    def serve_step(params, cache, tokens):
        logits, cache = decode_step(params, arch, cache, tokens, policy,
                                    mla_absorb=mla_absorb)
        next_tok = argmax_last(logits[:, -1, :])[:, None]
        return next_tok.to(torch.int32), logits, cache

    return serve_step
