"""Serving steps (the JAX package's ``launch/steps.py``, serving part):
greedy prefill and one-token decode. ``make_train_step`` waits for the
training slice (ROADMAP Queue 1 item 8).

Each step returns the next token ids (B, 1), the logits they were taken
from (B, vocab) fp32, and the cache.
"""
from __future__ import annotations

import torch


def make_prefill_step(model, max_len: int):
    """batch → (next_tok (B, 1), logits of the last position, cache)."""

    @torch.no_grad()
    def prefill_step(batch):
        logits, cache = model.prefill(batch, max_len)
        last = logits[:, -1].clone()    # not a view that keeps all logits
        return last.argmax(dim=-1, keepdim=True), last, cache

    return prefill_step


def make_serve_step(model):
    """(cache, tokens (B, 1)) → (next_tok (B, 1), logits, cache)."""

    @torch.no_grad()
    def serve_step(cache, tokens):
        logits, cache = model.decode_step(cache, tokens)
        return logits.argmax(dim=-1, keepdim=True), logits, cache

    return serve_step
