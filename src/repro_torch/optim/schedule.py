"""LR schedules: pure functions of the step.

Counterpart of ``repro.optim.schedule``.  The step may be a Python int or
a 0-d tensor; either gives the same float32 value (a tensor on the step's
device, the CPU for an int).
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1):
    t = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * t / max(1.0, warmup_steps)
    prog = torch.clamp((t - warmup_steps)
                       / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(t < warmup_steps, warm, cos)
