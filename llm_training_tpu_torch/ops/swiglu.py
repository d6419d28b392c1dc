"""SwiGLU activation. Counterpart of `llm_training_tpu/ops/swiglu.py`."""

from __future__ import annotations

import torch


def _logistic(x: torch.Tensor) -> torch.Tensor:
    # XLA's expansion of `lax.logistic`: negate, exp, add, divide, each
    # rounded in the input dtype
    return 1 / (1 + torch.exp(-x))


class _SiluMul(torch.autograd.Function):
    """`silu(gate) * up` with JAX's forward and its VJP in JAX's order:
    `jax.nn.silu` is `x * logistic(x)`, whose JVP is `t * s * (1 - s)`."""

    @staticmethod
    def forward(ctx, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(gate, up)
        return gate * _logistic(gate) * up

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        gate, up = ctx.saved_tensors
        s = _logistic(gate)
        grad_up = gate * s * grad
        ct = grad * up
        grad_gate = ct * s + (gate * ct) * (s * (1 - s))
        return grad_gate, grad_up


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up -- the SwiGLU elementwise core, rounded as JAX rounds
    it in bf16, forward and backward (`F.silu`, which rounds once from
    fp32, differs from it in about a third of the elements)."""
    return _SiluMul.apply(gate, up)
