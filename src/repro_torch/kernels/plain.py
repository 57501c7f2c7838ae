"""A kernel's plain version as a counter sees it.

On a CPU tensor each kernel wrapper runs its kernel's plain version. A
dispatch-mode counter (``launch.roofline.StepCounter``) sees every
operator of that version, whose intermediate values (a causal prefill's
(T, S) scores, a scan's states) the kernel keeps in registers and shared
memory. :func:`kernel_call` has an active counter fold them into one row
for the kernel: its operands read once, its outputs written once, the
plain version's dot FLOPs. With no counter active it does nothing.

    with kernel_call("flash_attention", q, k, v) as done:
        return done(flash_attention_gqa_torch(q, k, v, scale))

``done(out, flops=...)`` gives the row's FLOPs where the plain version
did not run: a wrapper handed fake tensors (a dry run's: shapes, no
values) may return empty outputs of the kernel's shapes instead of
running a plain version that loops over time steps.
"""
from __future__ import annotations

import contextlib

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def _same(out, flops=None):
    return out


@contextlib.contextmanager
def kernel_call(name: str, *operands):
    """Yields ``done(out, flops=None)``, which returns ``out`` and, under a
    counter, names it the call's outputs (and ``flops`` the call's dot
    FLOPs, in place of those the counter saw)."""
    counter = next((m for m in reversed(_get_current_dispatch_mode_stack())
                    if hasattr(m, "kernel_call")), None)
    if counter is None:
        yield _same
        return
    with counter.kernel_call(name, operands) as done:
        yield done
