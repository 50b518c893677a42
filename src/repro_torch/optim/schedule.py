"""Learning-rate schedules as plain functions of the integer step: the
port of ``repro.optim.schedule``.

Each returns a Python float equal to the reference's float32 value: the
arithmetic runs in ``np.float32`` as JAX promotes it (an int32 step
over a Python int divides in float32; a Python float meets a float32
value as float32), and ``np.where``'s choice is the reference's
``jnp.where``.  The cosine is the float64 ``cos`` rounded to float32
(the correctly rounded value); XLA's float32 ``cos`` differs from it by
one ulp at a few arguments (``tests/test_torch_lm_train.py`` counts
them), numpy's float32 ``cos`` at many more.
"""
from __future__ import annotations

import numpy as np

_f = np.float32


def _cos(x):
    return _f(np.cos(np.float64(x)))


def constant_schedule(lr):
    value = float(_f(lr))
    return lambda step: value


def cosine_schedule(peak_lr, total_steps, final_frac=0.1):
    def fn(step):
        frac = np.clip(_f(step) / _f(max(total_steps, 1)), _f(0), _f(1))
        cos = _f(0.5) * (_f(1) + _cos(_f(np.pi) * frac))
        return float(_f(peak_lr) * (_f(final_frac)
                                    + _f(1 - final_frac) * cos))
    return fn


def linear_warmup_cosine(peak_lr, warmup_steps, total_steps,
                         final_frac=0.1):
    def fn(step):
        warm = _f(peak_lr) * np.minimum(
            _f(1), _f(step + 1) / _f(max(warmup_steps, 1)))
        frac = np.clip(_f(step - warmup_steps)
                       / _f(max(total_steps - warmup_steps, 1)),
                       _f(0), _f(1))
        cos = _f(peak_lr) * (_f(final_frac) + _f((1 - final_frac) * 0.5)
                             * (_f(1) + _cos(_f(np.pi) * frac)))
        return float(np.where(step < warmup_steps, warm, cos))
    return fn
